"""PyTorch/CUDA port of the indirect-learning pose & shape system.

The JAX package ``indirect_learning_pose_shape_tpu`` is the reference; this
package mirrors its module layout (``models/``, ``ops/``, ``ops/kernels/``,
``utils/``, ``data/``, ``serve.py``, ``predict.py``, ``train.py``,
``evaluate.py``, ``losses.py``, ``configs.py``) and is checked
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
(soft part raster through the raster forward kernel) — and the config-4
training step, ``train.fused_step`` (on-device synthetic batch →
``forward_train`` → ``losses.total_loss`` → backward through the raster
backward kernel → the reference's optimizer menu: clipping, Adam/AdamW,
cosine warm-up, EMA), with every preset that needs no checkpoints, hard
targets, disk data or more than one GPU (``config4_mixed`` among them);
the reference's default ``separable`` raster with bf16 scores; and
``evaluate`` on the synthetic stream. Entry points run on CUDA unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
