"""Why `test_torch_presets.py` holds config4_large (ResNet-50) for 2 steps and
the other presets for 3: the float32 ResNet-50 training step is
ill-conditioned at the test's size, in the reference as in the port.

    python tests/presets_conditioning.py      # from the repository root, ~65 s on the CPU

Prints, at the test's size (width 8, IEF (128,), 64², tiny asset):

1. the relative gap of the total loss between the port's `train_step` and
   the reference's over 4 steps from the same parameters on one batch, and
   between the reference compiled with LLVM's optimisations off and the
   reference as XLA compiles it by default, for config4_large, config4_r34
   and config4_parts31 at b2;
2. the step-1 gradients of both float32 steps against a float64 step of
   the port whose BN statistics are taken in two passes (normalised per
   leaf, the worst leaf), for config4_large at b2 and b4;
3. the relative error of the one-pass float32 variance E[x²] − E[x]² of a
   [4, 16, 16, 256] array (mean ~11, std ~0.58) as XLA:CPU's and torch's
   reductions give it, against float64.
"""

import copy
import dataclasses
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_presets as presets  # noqa: E402
from indirect_learning_pose_shape_tpu import configs as jconfigs  # noqa: E402
from indirect_learning_pose_shape_tpu import train as jtrain  # noqa: E402
from indirect_learning_pose_shape_tpu.models import network as jnet  # noqa: E402
from indirect_learning_pose_shape_tpu.utils import assets as jassets  # noqa: E402
from indirect_learning_pose_shape_tpu_torch import configs, train  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.models import network as net  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.utils import convert  # noqa: E402


def _setup(asset, name, batch):
    """Both packages' configs, the port's model (the test's output layer),
    the reference's state holding its parameters, one batch, the
    reference's consts."""
    jcfg = presets._shrink(jconfigs.PRESETS[name], True, batch)
    cfg = presets._shrink(configs.PRESETS[name], False, batch)
    model, consts = net.init(asset, cfg.model, seed=1, device="cpu")
    with torch.no_grad():
        last = model.ief.layers[-1].weight
        last.copy_(torch.from_numpy(np.random.RandomState(0).randn(*last.shape).astype(np.float32) * 2e-4))
    jts = presets._reference_state(model, jcfg, asset)
    tbatch = train.make_batch(cfg.seed, 3, batch, consts, cfg)
    return jcfg, cfg, model, consts, jts, tbatch, jnet.build_consts(asset, jcfg.model)


def loss_gaps(asset, name, batch, steps=4):
    """Relative gaps of the total loss a step: the port against the
    reference, and the reference compiled with LLVM's optimisations off
    against itself as XLA compiles it by default (a change of rounding
    alone)."""
    jcfg, cfg, model, consts, jts0, tbatch, jconsts = _setup(asset, name, batch)
    jbatch = {k: v.numpy() for k, v in tbatch.items()}
    lowered = jax.jit(lambda t: jtrain.train_step(t, jbatch, jconsts, jcfg)).lower(jts0)
    runs = {}
    for label, step in (("default", lowered.compile()),
                        ("O0", lowered.compile(compiler_options={"xla_backend_optimization_level": 0}))):
        jts, runs[label] = jts0, []
        for _ in range(steps):
            jts, t = step(jts)
            runs[label].append(float(t["total"]))
    ts = train.new_state(model, cfg)
    got = [float(train.train_step(ts, tbatch, consts, cfg)["total"]) for _ in range(steps)]
    ref = runs["default"]
    return ([abs(a - b) / abs(b) for a, b in zip(got, ref)],
            [abs(a - b) / abs(b) for a, b in zip(runs["O0"], ref)])


def _two_pass_bn(y, bn, cfg, mesh=None):
    y64 = y.double()
    mean = y64.mean(dim=(0, 2, 3))
    var = torch.square(y64 - mean[:, None, None]).mean(dim=(0, 2, 3))
    inv = torch.rsqrt(var + cfg.bn_eps) * bn.scale.double()
    return (y64 * inv[:, None, None] + (bn.bias.double() - mean * inv)[:, None, None]).to(y.dtype)


def gradient_errors(asset, name, batch):
    jcfg, cfg, model, consts, jts, tbatch, jconsts = _setup(asset, name, batch)
    jbatch = {k: v.numpy() for k, v in tbatch.items()}
    (_, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_and_metrics(p, jts.model_state, jconsts, jbatch, jcfg), has_aux=True))(jts.params)
    jgrad = convert.jax_to_state_dict(jax.tree.map(np.asarray, jgrad), jax.tree.map(np.asarray, jts.model_state))

    def port(dtype, two_pass):
        m = copy.deepcopy(model)
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, encoder=dataclasses.replace(cfg.model.encoder, compute_dtype=dtype)))
        m.encoder.cfg = c.model.encoder
        plain = enc._batch_norm_train
        if two_pass:
            enc._batch_norm_train = _two_pass_bn
        try:
            total, _ = train.loss_and_metrics(m, consts, tbatch, c)
            total.backward()
        finally:
            enc._batch_norm_train = plain
        return {k: p.grad.double() for k, p in m.named_parameters()}

    truth = port(torch.float64, True)

    def worst(grads):
        return max(float((torch.tensor(np.asarray(grads[k])).double() - t).abs().max())
                   / (float(t.abs().max()) + 1e-30) for k, t in truth.items())

    return worst(port(torch.float32, False)), worst(jgrad)


def variance_errors():
    x = np.random.RandomState(0).uniform(0, 2, (4, 16, 16, 256)).astype(np.float32) + 10
    x64 = x.astype(np.float64)
    want = (x64**2).mean(axis=(0, 1, 2)) - x64.mean(axis=(0, 1, 2)) ** 2
    mean, meansq = jax.jit(lambda a: (jnp.mean(a, axis=(0, 1, 2)), jnp.mean(jnp.square(a), axis=(0, 1, 2))))(x)
    xla = np.asarray(meansq) - np.asarray(mean) ** 2
    t = torch.from_numpy(x)
    tv = (t.square().mean(dim=(0, 1, 2)) - t.mean(dim=(0, 1, 2)).square()).numpy()
    return float(np.abs(xla - want).max() / want.min()), float(np.abs(tv - want).max() / want.min())


def main() -> int:
    asset = jassets.synthetic_asset(num_verts=864, seed=1)
    for name in ("config4_large", "config4_r34", "config4_parts31"):
        port, o0 = loss_gaps(asset, name, 2)
        print(f"{name} b2: |a - reference| / reference of the total loss, steps 1-4: port "
              + " ".join(f"{g:.2e}" for g in port) + "; the reference at XLA optimisation level 0 "
              + " ".join(f"{g:.2e}" for g in o0))
    for b in (2, 4):
        p, r = gradient_errors(asset, "config4_large", b)
        print(f"config4_large b{b}: step-1 gradients against a float64 step with two-pass BN "
              f"statistics, worst leaf: port float32 {p:.3e}, reference float32 {r:.3e}")
    xla, tv = variance_errors()
    print(f"one-pass float32 variance of a [4, 16, 16, 256] array, relative error: XLA:CPU {xla:.3e}, torch {tv:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
