"""PyTorch port, the int8 serving path: `quantize.quantized_forward` (int8
encoder, then IEF, SMPL, projection) against the JAX reference's on the
same qparams, and `serve.Predictor(qparams=...)` bucketing: padded rows
unchanged, outputs sliced to the request.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.models import encoder as jenc
from indirect_learning_pose_shape_tpu.models import ief as jief
from indirect_learning_pose_shape_tpu.models import network as jnet
from indirect_learning_pose_shape_tpu.models import quantize as jq
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch import serve
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize as q
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.utils import convert

SIZE = 48


def _port_cfg():
    return net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=16, compute_dtype=torch.float32, fold_bn_eval=True),
        ief=ief.IEFConfig(hidden_dims=(128,)),
        raster=raster.RasterConfig(image_size=SIZE),
    )


@pytest.fixture(scope="module")
def setup(tiny_asset):
    """JAX params with BN statistics moved by one train-mode pass, their
    qparams from a calibration batch, and the port's model with the same
    weights."""
    jcfg = jnet.ModelConfig(
        image_size=SIZE,
        encoder=jenc.EncoderConfig(depth=18, width=16, compute_dtype=jnp.float32, fold_bn_eval=True),
        ief=jief.IEFConfig(hidden_dims=(128,)),
        raster=jraster.RasterConfig(image_size=SIZE),
    )
    params, state, jconsts = jnet.init(jax.random.PRNGKey(0), tiny_asset, jcfg)
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (8, SIZE, SIZE, 3)).astype(np.float32)
    _, state = jax.jit(lambda p, s, x: jnet.forward(p, s, jconsts, x, jcfg, train=True))(
        params, state, images[:4]
    )
    params, state = jax.tree.map(np.asarray, (params, state))
    last = params["ief"]["layers"][-1]
    last["w"] = (rng.randn(*last["w"].shape) * 2e-4).astype(np.float32)
    jqp = jax.jit(jq.ptq_quantize, static_argnums=(2,))(
        params["encoder"], state["encoder"], jcfg.encoder, images[4:]
    )
    cfg = _port_cfg()
    model, consts = net.init(tiny_asset, cfg, seed=1, device="cpu")
    convert.load_jax_params(model, params, state)
    qp = {s: {k: torch.from_numpy(np.array(v)) for k, v in d.items()} for s, d in jqp.items()}
    return dict(jcfg=jcfg, params=params, jconsts=jconsts, jqp=jqp, images=images,
                cfg=cfg, model=model, consts=consts, qp=qp)


@pytest.mark.parametrize("impl", ["int8", "int8c"])
def test_quantized_forward_matches_jax(setup, impl):
    s = setup
    x = s["images"][:3]
    ref = jax.jit(
        lambda qp, ip, im: jq.quantized_forward(qp, ip, s["jconsts"], im, s["jcfg"], impl=impl)
    )(s["jqp"], s["params"]["ief"], x)
    got = q.quantized_forward(s["qp"], s["model"].ief, s["consts"], torch.from_numpy(x), s["cfg"], impl)
    assert set(got) == set(ref)
    assert float(np.abs(np.asarray(ref["pose"])).max()) > 1e-3  # off the mean parameters
    for k in ("theta", "verts", "kp2d", "joints"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)


@pytest.mark.parametrize("impl", ["int8", "int8c", "sim", "simc"])
def test_predictor_qparams_bucketing(setup, impl):
    s = setup
    p = serve.Predictor(s["cfg"], s["model"], s["consts"], buckets=(2, 4, 8), qparams=s["qp"], int8_impl=impl)
    x = s["images"]
    out3 = p(x[:3])  # padded 3 -> 4
    out8 = p(x)
    assert out3["verts"].shape[0] == 3 and p.bucket_for(3) == 4
    direct = q.quantized_forward(s["qp"], s["model"].ief, s["consts"], torch.from_numpy(x[:3]), s["cfg"], impl)
    for k in out3:
        np.testing.assert_allclose(out3[k].numpy(), out8[k][:3].numpy(), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(out3[k].numpy(), direct[k].detach().numpy(), atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="int8_impl"):
        serve.Predictor(s["cfg"], s["model"], s["consts"], qparams=s["qp"], int8_impl="int4")
