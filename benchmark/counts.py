"""The work a training step or a rendered ray needs, counted from the
configuration's widths and sample counts (never from the program's code),
and the card's published peaks to divide it by.

Matrix FLOPs: an affine layer of in-width ``Di`` and out-width ``Do``
applied to ``n`` rows costs ``2 n Di Do`` forward, as much again for the
gradient of its input and as much for the gradient of its weights.  A
training step counts, per network (``B R`` rays; ``N`` foreground samples
a ray, ``n0 + U n1``; ``Np`` proposal samples, ``n0 + (U - 1) n1``, whose
SDF the sampler evaluates without a graph; ``Nb`` background samples;
``M = n_thetas x 2 n_thetas`` light directions of each of the two kinds):

- geometric network at the ``N`` samples: the forward, the spatial
  gradient (an input-gradient pass), and the backward of both (the
  eikonal double backward): 6 forwards;
- geometric network at the perturbed samples (the base-colour prior): a
  forward and its backward, 3 forwards; at the proposal samples 1;
- the heads at the samples (base colour twice: the samples and the
  perturbed ones; implicit illumination, roughness, specular reflectance,
  photogrammetric light once), 3 forwards each;
- environment light and soft visibility over ``B R M`` directions of each
  kind, the soft visibility's per-pixel inputs projected once a pixel
  (the split first layer), 3 forwards each but for the input gradient of
  a first layer whose inputs carry no gradient (the directions, the
  background points);
- the NeRF++ background at the ``Nb`` samples.

Nothing recomputed is counted (``train.remat_heads`` recomputes the heads;
the counter refuses it).  A rendered ray counts the forwards and the
spatial-gradient pass only.  Elementwise work, the grid queries and the
optimizer are not matrix work and are not counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA's data sheets, dense rates: (HBM bytes/s, FLOP/s by the MLP's
# operand precision: float32 outside the tensor cores, bfloat16 on them)
_PEAKS = (("H200", 4.8e12, 67e12, 989e12),
          ("H100 PCIe", 2.0e12, 51e12, 756e12),
          ("H100 NVL", 3.9e12, 60e12, 835e12),
          ("H100", 3.35e12, 67e12, 989e12))


def card_peaks(name: str) -> Dict[str, float]:
    """{"bytes_per_s", "float32", "bfloat16"} for the card ``name`` as
    ``torch.cuda.get_device_name`` gives it (the SXM part's at 700 W for a
    plain "H100")."""
    for key, mem, f32, bf16 in _PEAKS:
        if all(part in name for part in key.split()):
            return {"bytes_per_s": mem, "float32": f32, "bfloat16": bf16}
    raise ValueError(f"no published peak rates for {name!r}")


def pe_dim(c: int, bands: int) -> int:
    return c if bands <= 0 else c + 2 * c * bands


def grid_width(conf) -> int:
    """The width of the grid encoding's output."""
    v = conf["geometric_network"]["voxel"]
    if v["type"] == "none":
        return 0
    if v["type"] in ("voxel_hash", "lanczos_voxel_hash"):
        return v["feature_size"] * v.get("hash_levels", 16)
    if v["type"].endswith("triplaneline"):
        return 2 * v["feature_size"]
    return v["feature_size"]


def geometric_layers(conf) -> List[Tuple[int, int]]:
    """(in, out) of each layer of the SDF network under the geometric
    initialization's layout: the layer before a skip narrows by the
    inputs' width, the skip concatenates them back."""
    g = conf["geometric_network"]
    D, L, skips = g["feature_size"], g["layers"], tuple(g["skip_layers"])
    din = pe_dim(3, g["pe_bands"]) + grid_width(conf)
    if not g["geometric_init"]:
        raise ValueError("the counter follows the geometric initialization's "
                         "layer widths")
    layers, h = [], din
    for l in range(L):
        if l == 0:
            do = D
        elif l == L - 1:
            do = D + 1
        elif l in skips:
            do = D
        else:
            do = D - din if (l + 1) in skips else D
        layers.append((h, do))
        h = do + (din if (l + 1) in skips and l != 0 and l not in skips
                  else 0)
    return layers


def _stack(din: int, width: int, layers: int, dout: int):
    dims = [din] + [width] * (layers - 1) + [dout]
    return list(zip(dims[:-1], dims[1:]))


def head_layers(conf) -> Dict[str, List[Tuple[int, int]]]:
    """(in, out) of each layer of every head that the config uses."""
    D = conf["geometric_network"]["feature_size"]

    def cond_in(c, *extra):
        return 3 + sum(extra) + (D if c["use_geometric_feature"] else 0) \
            + (3 if c["use_normal"] else 0)

    out = {}
    c = conf["base_color_network"]
    out["base_color"] = _stack(cond_in(c), c["feature_size"], c["layers"], 3)
    c = conf["environment_light_network"]
    out["env"] = _stack(pe_dim(3, c["pe_bands"]), c["feature_size"],
                        c["layers"], c["channels"])
    c = conf["soft_visibility_light_network"]
    out["soft_vis"] = _stack(cond_in(c, pe_dim(3, c["pe_bands"])),
                             c["feature_size"], c["layers"], c["channels"])
    c = conf["implicit_illumination_network"]
    if c["use_me"]:
        out["implicit"] = _stack(cond_in(c), c["feature_size"], c["layers"],
                                 c["channels"])
    c = conf["photogrammetric_light_network"]
    if c["use_me"]:
        din = 3 + pe_dim(3, c["pe_bands"]) + D + 3 \
            + (1 if c["use_inverse_distance"] else 0)
        out["photo"] = _stack(din, c["feature_size"], c["layers"],
                              c["channels"])
    c = conf["roughness_network"]
    out["rough"] = _stack(cond_in(c), c["feature_size"], c["layers"], 2)
    c = conf["specular_reflectance_network"]
    if not c["fixme"]:
        out["spec"] = _stack(cond_in(c), c["feature_size"], c["layers"],
                             2 * c["channels"])
    if conf["background_modeling"]:
        c = conf["background_network"]
        out["bg_geo"] = _stack(pe_dim(4, c["pe_bands0"]), c["feature_size0"],
                               c["layers0"], c["feature_size0"] + 1)
        out["bg_light"] = _stack(4 + c["feature_size0"] + 3
                                 + pe_dim(3, c["pe_bands1"]),
                                 c["feature_size1"], c["layers1"], 3)
    return out


def forward_flops(layers) -> int:
    """Matrix FLOPs of one row through the layers."""
    return sum(2 * a * b for a, b in layers)


def _soft_vis_flops(conf, pixels: int, dirs: int) -> Tuple[int, int]:
    """(forward, first-layer part over the directions) of the soft
    visibility over ``dirs`` directions of ``pixels`` pixels: the per-pixel
    inputs of its first layer are projected once a pixel."""
    c = conf["soft_visibility_light_network"]
    layers = head_layers(conf)["soft_vis"]
    per_dir_in = pe_dim(3, c["pe_bands"])
    first_in, width = layers[0]
    first_pixel = 2 * pixels * (first_in - per_dir_in) * width
    first_dir = 2 * dirs * per_dir_in * width
    return first_pixel + first_dir + dirs * forward_flops(layers[1:]), \
        first_dir


def _sample_counts(conf) -> Tuple[int, int, int, int]:
    r = conf["renderer"]
    n = r["n_samples0"] + r["n_upsamples"] * r["n_samples1"]
    n_prop = r["n_samples0"] + max(r["n_upsamples"] - 1, 0) * r["n_samples1"]
    M = r["n_thetas"] * 2 * r["n_thetas"]
    nb = r["n_bg_samples"] if conf["background_modeling"] else 0
    return n, n_prop, nb, M


def _work(conf, rays: int, train: bool) -> int:
    if train and conf["train"].get("remat_heads", False):
        raise ValueError("the counter counts no recomputation: "
                         "train.remat_heads is on")
    n, n_prop, nb, M = _sample_counts(conf)
    geo = forward_flops(geometric_layers(conf))
    heads = head_layers(conf)
    pts = rays * n
    total = rays * n_prop * geo                       # proposals, no graph
    total += (6 if train else 2) * pts * geo          # samples, the normal
    total += (3 if train else 1) * pts * geo          # perturbed samples
    mult = 3 if train else 1
    total += mult * 2 * pts * forward_flops(heads["base_color"])
    for name in ("implicit", "photo", "rough", "spec"):
        if name in heads:
            total += mult * pts * forward_flops(heads[name])
    for _ in range(2):                                # diffuse, specular
        env = forward_flops(heads["env"])
        first = 2 * heads["env"][0][0] * heads["env"][0][1]
        total += rays * M * (env + (2 * env - first if train else 0))
        sv, sv_first_dir = _soft_vis_flops(conf, rays, rays * M)
        total += sv + (2 * sv - sv_first_dir if train else 0)
    if "bg_geo" in heads:
        bgp = rays * nb
        f = forward_flops(heads["bg_geo"])
        first = 2 * heads["bg_geo"][0][0] * heads["bg_geo"][0][1]
        total += bgp * (f + (2 * f - first if train else 0))
        total += mult * bgp * forward_flops(heads["bg_light"])
    return total


def train_step_flops(conf) -> int:
    """Matrix FLOPs of one training step of ``train.batch_size x
    train.n_rays`` rays."""
    return _work(conf, conf["train"]["batch_size"] * conf["train"]["n_rays"],
                 train=True)


def render_ray_flops(conf) -> int:
    """Matrix FLOPs of one rendered ray (a view's pixel)."""
    return _work(conf, 1, train=False)


def scatter_bytes(n: int, d: int, rows: int, id_bytes: int,
                  val_bytes: int) -> int:
    """The least bytes of one scatter-add of ``n`` rows of ``d`` values into
    a ``rows x d`` f32 table: each id and value read once, each output
    float written once."""
    return n * id_bytes + n * d * val_bytes + rows * d * 4
