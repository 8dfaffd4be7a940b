"""Model FLOPs from the layer shapes (2 FLOPs a multiply-add).

- Encoder: every convolution of the ResNet at the crop size, output
  positions x cout x cin x k². A training step adds the backward: the
  weight gradient of every convolution and the input gradient of every one
  but the stem (the images need none). BatchNorm, ReLU, pooling and the
  residual adds are not counted: they are not products.
- IEF: each feedback iteration's linear layers; training x3.
- SMPL: the shape and pose blendshapes, the joint regression, skinning
  and the keypoint regression, per body (`lbs_flops`); the training step
  poses the target bodies once and the predicted ones forward and backward.
- The soft raster's needed pairs are counted from the data
  (`portbench/work/raster.py`), one FMA a pair forward and two backward.
"""

from __future__ import annotations

from portbench.reference import model as model_lib


def conv_layers(depth: int, size: int, width: int = 64):
    """[(name, out_h, out_w, cin, cout, k)] of the ResNet at `size`²."""
    def out(n, k, s):
        return (n + 2 * ((k - 1) // 2) - k) // s + 1

    h = out(size, 7, 2)
    layers = [("stem", h, h, 3, width, 7)]
    h = out(h, 3, 2)  # max-pool 3/2 pad 1
    for name, cin, cout, stride in model_lib.blocks(depth, width):
        h2 = out(h, 3, stride)
        layers.append((name + ".conv1", h2, h2, cin, cout, 3))
        layers.append((name + ".conv2", h2, h2, cout, cout, 3))
        if stride != 1 or cin != cout:
            layers.append((name + ".proj", out(h, 1, stride), out(h, 1, stride), cin, cout, 1))
        h = h2
    return layers


def encoder_macs(depth: int, size: int) -> int:
    """Multiply-adds of one image's forward."""
    return sum(oh * ow * cin * cout * k * k for _, oh, ow, cin, cout, k in conv_layers(depth, size))


def ief_macs(feature_dim: int, theta_dim: int, hidden=(1024, 1024), iterations: int = 3) -> int:
    dims = [feature_dim + theta_dim, *hidden, theta_dim]
    return iterations * sum(a * b for a, b in zip(dims, dims[1:]))


def lbs_flops(num_verts: int = 6890, num_joints: int = 24, num_betas: int = 10) -> int:
    """One body: blendshapes (3·Kb + 3·Kp), skinning (12·J) and the posed
    vertex (9) per vertex, the joint and keypoint regressions (3·V each a
    row), 2 FLOPs a multiply-add."""
    kp = (num_joints - 1) * 9
    per_vertex = 3 * num_betas + 3 * kp + 12 * num_joints + 9
    return 2 * (num_verts * per_vertex + 3 * num_verts * (num_joints + 19))


def train_flops_per_image(depth: int, size: int, theta_dim: int, raster_fmas: float) -> float:
    """A training image: encoder forward and backward, IEF x3, SMPL target
    + prediction forward + backward (x2), and the raster's FMAs on the
    needed pairs (`raster_fmas` a image: the forwards' one a pair, the
    backward's two)."""
    fwd = encoder_macs(depth, size)
    stem = conv_layers(depth, size)[0]
    stem_macs = stem[1] * stem[2] * stem[3] * stem[4] * stem[5] ** 2
    encoder = 2 * (3 * fwd - stem_macs)
    return encoder + 2 * 3 * ief_macs(512, theta_dim) + 4 * lbs_flops() + 2 * raster_fmas


def serve_flops_per_image(depth: int, size: int, theta_dim: int) -> float:
    """A served crop's forward: encoder, IEF, SMPL."""
    return 2 * encoder_macs(depth, size) + 2 * ief_macs(512, theta_dim) + lbs_flops()
