"""PyTorch/CUDA port of the indirect-learning pose & shape system.

The JAX package ``indirect_learning_pose_shape_tpu`` is the reference; this
package mirrors its module layout (``models/``, ``ops/``, ``ops/kernels/``,
``utils/``, ``serve.py``, ``predict.py``, ``configs.py``) and is checked
against it module by module. It imports ``torch`` and never ``jax``, and
nothing of the reference package: the numpy pieces it needs (the SMPL asset,
the part layout) are copies, tested equal to the reference's.

Every Pallas kernel on a ported path is a hand-written CUDA kernel for
Hopper (``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at first use by
``ops/kernels/_build.py``), with a plain PyTorch twin beside it that the
wrapper uses for CPU tensors.

Covered so far: the serving path — ``serve.Predictor`` over
``models.network.forward`` (ResNet encoder → IEF → SMPL with the fused LBS
kernel → weak-perspective projection) plus ``predict.render_silhouette``
(soft part raster through the raster forward kernel).
"""

__version__ = "0.1.0"
