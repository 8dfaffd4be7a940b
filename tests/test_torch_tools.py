"""PyTorch port, the small tools: `tools/convert_smpl_pkl.py` on a
chumpy-era pickle (the same arrays as the reference's conversion), and the
card-only `tools/profile_step.py` refusing to run without a CUDA device.
"""

import numpy as np

from indirect_learning_pose_shape_tpu.utils import assets as jassets
from indirect_learning_pose_shape_tpu_torch.tools import convert_smpl_pkl, profile_step
from indirect_learning_pose_shape_tpu_torch.utils import assets
from tests.test_predict_and_tools import _fake_chumpy_pkl

FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "cocoplus_regressor", "weights", "parents", "faces")


def test_convert_smpl_pkl_matches_reference(tmp_path, capsys):
    src = jassets.synthetic_asset(num_verts=864, seed=4)
    pkl, npz = str(tmp_path / "model.pkl"), str(tmp_path / "sub" / "smpl.npz")
    _fake_chumpy_pkl(pkl, src)
    assert convert_smpl_pkl.main([pkl, npz]) == 0
    assert "V=864 J=24 betas=10" in capsys.readouterr().out
    got = assets.load_npz(npz)
    want = jassets.load_pkl(pkl)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_profile_step_needs_a_card(capsys):
    assert profile_step.main(["--steps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
