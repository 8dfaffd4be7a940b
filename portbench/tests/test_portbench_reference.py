"""The plain reference against the port at a tiny size on the CPU: its parts
one by one, then a training step's and a request's compared numbers
through the whole harness (`tiny.py`: 64² crops, the 864-vertex stand-in,
batches of 2)."""

import numpy as np
import pytest
import torch

from portbench import inputs, run
from portbench.reference import body, hard, raster
from portbench.reference.precision import Precision, round_fp8, round_tf32
from portbench.tests.tiny import tiny_root

from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl as port_smpl
from indirect_learning_pose_shape_tpu_torch.ops import raster as port_raster
from indirect_learning_pose_shape_tpu_torch.ops import raster_hard as port_hard
from indirect_learning_pose_shape_tpu_torch.utils import assets as port_assets


@pytest.fixture(scope="module")
def tiny():
    asset = inputs.stand_in(num_verts=864, seed=1)
    cfg = net.ModelConfig(image_size=64, raster=port_raster.RasterConfig(image_size=64))
    consts = net.build_consts(inputs.port_asset(asset), cfg, "cpu")
    return asset, cfg, consts


def test_stand_in_is_the_ports_asset_bitwise():
    a = inputs.stand_in(num_verts=864, seed=1)
    b = port_assets.synthetic_asset(num_verts=864, seed=1)
    for k in inputs.ASSET_FIELDS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_smpl_matches_the_port(tiny):
    asset, cfg, consts = tiny
    gen = torch.Generator().manual_seed(0)
    pose = 0.3 * torch.randn(3, 72, generator=gen)
    betas = torch.randn(3, 10, generator=gen)
    rot = body.rodrigues(pose.reshape(3, 24, 3))
    mine = body.smpl(body.body_from_asset(asset, 24, "cpu"), rot, betas, Precision())
    port = port_smpl.smpl_forward_rotmats(consts.smpl, rot, betas, impl="torch")
    for k in ("verts", "joints", "kp3d"):
        assert float((mine[k] - port[k]).abs().max()) < 2e-6, k
    r6 = torch.randn(3, 24, 6, generator=gen)
    assert torch.allclose(body.rot6d_to_rotmat(r6), port_smpl.rot6d_to_rotmat(r6), atol=1e-6)


def test_soft_raster_matches_the_ports_plain_raster(tiny):
    asset, cfg, consts = tiny
    b = body.body_from_asset(asset, 24, "cpu")
    gen = torch.Generator().manual_seed(1)
    verts2d = 32 + 12 * torch.randn(2, 864, 2, generator=gen)
    mine = raster.scores(verts2d, raster.parts(b.labels, 24, "cpu"), 64, 2.0, Precision())
    port = port_raster.raster_scores_cf(verts2d, consts.part_layout, cfg.raster, impl="torch")
    assert float((mine - port).abs().max() / port.abs().max()) < 1e-5


def test_hard_raster_matches_the_port(tiny):
    asset, cfg, consts = tiny
    b = body.body_from_asset(asset, 24, "cpu")
    gen = torch.Generator().manual_seed(2)
    verts2d = 32 + 10 * torch.randn(2, 864, 2, generator=gen)
    z = torch.randn(2, 864, generator=gen)
    light = torch.randn(2, 3, generator=gen)
    fclass = torch.as_tensor(hard.face_class(asset.faces, b.labels))
    mine = hard.hard_raster(verts2d, z, b.faces, fclass, 64, with_shade=True, light=light)
    port = port_hard.hard_raster(verts2d, z, consts.hard, 64, with_shade=True, light=light)
    for k in ("part_labels", "silhouette", "shade"):
        assert torch.equal(mine[k], port[k]), k


def test_control_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0e-5])
    assert round_tf32(x).tolist()[:3] == [1.0, 1.0, 1.0 + 4 * 2**-11]
    q, s = round_fp8(torch.linspace(-2, 2, 101))
    assert q.dtype == torch.bfloat16 and len(torch.unique(q)) < 101 and float(s) == pytest.approx(2 / 448)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["train.config4_full.soft_b32", "train.config4_mixed.hard_b32"])
def test_training_step_against_the_reference(root, workload):
    line = run.run_cell(workload, 2**31 + 3, 0.5, False, "cpu", root=root, started=0.0)
    n = line["_info"]["numbers"]
    notes = line["_info"]["notes"]
    assert notes["loss"][0] == pytest.approx(notes["loss_ref"][0], rel=1e-5)
    assert n["grad_leaf"] < 1e-2, n
    assert n["loss_rel"] < 1e-2 and n["change_leaf"] < 0.2, n
    run_info = line["_info"]["run"]
    assert run_info["replay_step"] == run_info["program_step"] > 0
    assert n["replay_loss_rel"] < 1e-2 and n["replay_change_leaf"] < 0.2, n


@pytest.mark.parametrize("workload", ["serve.config4_full.interactive", "serve.config4_full.bulk128"])
def test_request_against_the_reference(root, workload):
    line = run.run_cell(workload, 2**31 + 4, 0.5, False, "cpu", root=root, started=0.0)
    n = line["_info"]["numbers"]
    assert line["_info"]["notes"]["kept_requests"] >= 1
    assert n["verts_m"] < 1e-3 and n["kp2d_px"] < 0.05 and n["theta_rel"] < 0.05, n
    if "sil" in n:
        assert n["sil"] < 1e-2, n
