"""The fault ladder behind `tools/recipe_parity.py`'s r34_indirect_5k result:
each check that the miss was held to, for the record in ROADMAP.md Queue 3.

On the card (torch only; each variant trains r34_indirect_5k at seed 0 for
its 5000 steps on `fit`'s CUDA graph, ~2.5 min, and prints the plain-suite
protocol's means as JSON):

    python tests/recipe_ladder.py ief_bf16         # IEF's products in one bf16 pass with float32 sums
    python tests/recipe_ladder.py f32_encoder      # the encoder in float32 (TF32 off)
    python tests/recipe_ladder.py batch_stats      # scored with the running BN statistics, then with each batch's
    python tests/recipe_ladder.py save OUT.npz     # the trained model's state dict as float16, for `evaluators`
    python tests/recipe_ladder.py adam             # the update alone, ~5 s (below)

`adam`: the port's update (clip 1.0, Adam, the cosine schedule over 400
steps with 20 of warm-up, lr 3e-4) on random gradients of three leaves,
on the card (capturable, the rate a tensor there) against the CPU and a
float64 numpy optax chain: the largest parameter gaps.

On the CPU (JAX and torch; from the repository root):

    python tests/recipe_ladder.py stream           # ~2 min
    python tests/recipe_ladder.py evaluators OUT.npz   # ~10 min
    python tests/recipe_ladder.py grads            # ~4 min

`stream`: the evaluation streams of seeds 123, 231, 312 x 8 batches of 32
at the recipe's full size (256², the V=6890 synthetic asset, separable
targets), port against reference: the mean of per-batch silhouette
area, keypoint visibility, image mean and spread, foreground labels,
keypoint centre and spread and part classes present, with the difference
over its standard error. `evaluators`: one model (the port's state dict in
OUT.npz, or the seed-0 init with `init`) scored by the port's
`evaluate` and by the reference's on their own streams, protocol size.
The port's evaluator also prints the standard deviation of one image's
PVE. `grads`: the reference trained for 80 steps (width 8, 64², b4, float32
encoder, IEF (1024, 1024), cosine with 5 warm-up steps, clip 1.0,
shape_reg 3e-3); at steps 0, 20, 40 and 79 its parameters are loaded into
the port and one step's loss terms and gradients compared (worst leaves
and IEF's leaves, normalised); then the head alone (IEF, SMPL, projection,
render, losses) from the same encoder features.
"""

import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), REPO]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, train  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.models import ief as ief_mod  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.models import network as net  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.models import smpl as smpl_mod  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.tools import quality_eval  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.tools import recipe_parity as rp  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.utils import assets  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.utils import convert  # noqa: E402
from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32  # noqa: E402

RECIPE = rp.RECIPES["r34_indirect_5k"]


def _means(summary: dict) -> dict:
    return {k: round(v["mean"], 5) for k, v in summary.items()}


def _card_run(tag: str, cfg=None, score_batch_stats: bool = False) -> None:
    disable_tf32()
    asset = assets.load_asset()
    cfg = cfg or rp.recipe_config(RECIPE)
    ts, route, logged = rp._train(cfg, asset, torch.device("cuda"))
    consts = net.build_consts(asset, cfg.model, "cuda")
    ecfg, _ = evaluate.eval_config(cfg, suite="plain")
    _, summary = quality_eval.protocol(ts.model, consts, ecfg)
    print(json.dumps({"variant": tag, "route": route, "last_total": logged[-1][1], **_means(summary)}), flush=True)
    if score_batch_stats:
        plain = net.forward_train

        def batch_stats(model, consts, images, cfg, train=True, probs=True, mesh=None):
            return plain(model, consts, images, cfg, train=True, probs=probs, mesh=mesh)

        evaluate.net.forward_train = batch_stats
        evaluate.clear_graphs()  # the cached graphs read the running statistics
        _, summary = quality_eval.protocol(ts.model, consts, ecfg)
        print(json.dumps({"variant": "batch_stats", **_means(summary)}), flush=True)
    return ts


def _ief_apply_bf16(ief, features):
    """`ief_apply` with each product's operands rounded to bf16 and float32
    sums, as a float32 matmul at a TPU's default precision."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    theta = ief.mean_theta[None, :].expand(features.shape[0], -1)
    last = len(ief.layers) - 1
    for _ in range(ief.cfg.num_iterations):
        x = torch.cat([features, theta], dim=1)
        for i, layer in enumerate(ief.layers):
            x = F.linear(bf(x), bf(layer.weight), layer.bias)
            if i < last:
                x = F.relu(x)
        theta = theta + x
    return theta


def adam() -> None:
    disable_tf32()
    n = 400
    cfg = dataclasses.replace(configs.TrainConfig(), learning_rate=3e-4, lr_schedule="cosine",
                              warmup_steps=20, num_steps=n, grad_clip_norm=1.0)
    rng = np.random.RandomState(0)
    shapes = [(64, 32), (32,), (8, 3, 3, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * rng.choice([0.01, 0.3, 3.0])).astype(np.float32) for s in shapes] for _ in range(n)]

    class Leaves(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params])

    runs = {}
    for dev in ("cpu", "cuda"):
        ts = train.new_state(Leaves().to(dev), cfg)
        traj = []
        for g in grads:
            for p, a in zip(ts.model.parameters(), g):
                p.grad = torch.from_numpy(a.copy()).to(dev)
            train.apply_update(ts, cfg)
            traj.append(np.concatenate([p.detach().cpu().numpy().ravel() for p in ts.model.parameters()]))
        runs[dev] = np.array(traj)
    p = [a.astype(np.float64) for a in params]
    mu, nu, ref = [np.zeros_like(a) for a in p], [np.zeros_like(a) for a in p], []
    for t, g in enumerate(grads):
        g = [a.astype(np.float64) for a in g]
        norm = np.sqrt(sum((a * a).sum() for a in g))
        if norm >= cfg.grad_clip_norm:
            g = [a / norm * cfg.grad_clip_norm for a in g]
        lr = cfg.learning_rate * train.lr_factor(t, cfg)
        mu = [0.9 * m + 0.1 * a for m, a in zip(mu, g)]
        nu = [0.999 * v + 0.001 * a * a for v, a in zip(nu, g)]
        p = [a - lr * (m / (1 - 0.9 ** (t + 1))) / (np.sqrt(v / (1 - 0.999 ** (t + 1))) + 1e-8)
             for a, m, v in zip(p, mu, nu)]
        ref.append(np.concatenate([a.ravel() for a in p]))
    ref = np.array(ref)
    start = np.concatenate([a.ravel() for a in params])
    print(json.dumps({
        "cuda_vs_cpu_max": float(np.abs(runs["cuda"] - runs["cpu"]).max()),
        "cpu_vs_f64_max": float(np.abs(runs["cpu"] - ref).max()),
        "cuda_vs_f64_max": float(np.abs(runs["cuda"] - ref).max()),
        "largest_move": float(np.abs(ref[-1] - start).max()),
    }))


def stream() -> None:
    import jax
    from indirect_learning_pose_shape_tpu import configs as jconfigs
    from indirect_learning_pose_shape_tpu.data import synthetic as jsyn
    from indirect_learning_pose_shape_tpu.models import network as jnet
    from indirect_learning_pose_shape_tpu.utils import assets as jassets

    nb, b = 8, 32
    cfg = rp.recipe_config(RECIPE, 0, "separable")
    jcfg = jconfigs.PRESETS["config4_r34"]
    consts = net.build_consts(assets.load_asset(), cfg.model, "cpu")
    jconsts = jnet.build_consts(jassets.load_asset(), jcfg.model)
    gen = jax.jit(lambda k: jsyn.generate_batch(k, b, jconsts, jcfg.model, jcfg.synthetic))

    def stats(x):
        return {"silhouette": np.mean(x["silhouette"]), "kp_vis": np.mean(x["kp_vis"]),
                "image_mean": np.mean(x["image"]), "image_std": np.std(x["image"]),
                "foreground_labels": np.mean(x["part_labels"] > 0),
                "kp_x": np.mean(x["kp2d"][..., 0]), "kp_y": np.mean(x["kp2d"][..., 1]),
                "kp_spread": np.mean(np.std(x["kp2d"], axis=1)),
                "classes_present": np.mean([len(np.unique(y)) for y in x["part_labels"]])}

    ours, theirs = [], []
    for seed in quality_eval.PROTOCOL_SEEDS:
        for i in range(nb):
            g = torch.Generator().manual_seed(train.step_seed(seed, i))
            ours.append(stats({k: v.numpy() for k, v in train._draw_batch(g, b, consts, cfg).items()}))
        for key in jax.random.split(jax.random.PRNGKey(seed), nb):
            theirs.append(stats({k: np.asarray(v) for k, v in gen(key).items()}))
    for k in ours[0]:
        p, r = np.array([x[k] for x in ours]), np.array([x[k] for x in theirs])
        se = np.sqrt(p.var() / len(p) + r.var() / len(r))
        print(f"{k:18s} port {p.mean():.5f}  reference {r.mean():.5f}  difference / SE {(p.mean() - r.mean()) / se:+.2f}")


def _reference_side(model, jcfg, jasset):
    from test_torch_presets import _reference_state

    return _reference_state(model, jcfg, jasset)


def evaluators(path: str) -> None:
    from indirect_learning_pose_shape_tpu import configs as jconfigs
    from indirect_learning_pose_shape_tpu import evaluate as jevaluate
    from indirect_learning_pose_shape_tpu.models import network as jnet
    from indirect_learning_pose_shape_tpu.utils import assets as jassets

    torch.set_num_threads(os.cpu_count() or 1)
    cfg = rp.recipe_config(RECIPE, 0, "separable")
    jcfg = jconfigs.PRESETS["config4_r34"]
    asset, jasset = assets.load_asset(), jassets.load_asset()
    model, consts = net.init(asset, cfg.model, seed=0, device="cpu")
    if path != "init":
        with np.load(path) as z:
            model.load_state_dict({k: torch.from_numpy(z[k].astype(np.float32) if z[k].dtype == np.float16 else z[k])
                                   for k in z.files})
    jts = _reference_side(model, jcfg, jasset)
    jconsts = jnet.build_consts(jasset, jcfg.model)
    seeds = quality_eval.PROTOCOL_SEEDS
    ecfg, _ = evaluate.eval_config(cfg, suite="plain")
    _, summary = quality_eval.protocol(model, consts, ecfg, seeds, 8)
    print("port evaluate     ", json.dumps(_means(summary)), flush=True)
    ref = [jevaluate.evaluate(jts.params, jts.model_state, jconsts, jcfg, num_batches=8, seed=s) for s in seeds]
    print("reference evaluate", json.dumps({k: round(float(np.mean([r[k] for r in ref])), 5) for k in ref[0]}), flush=True)
    # The spread of one image's PVE, over the port's first two batches of each seed.
    per_image = []
    with torch.no_grad():
        for s in seeds:
            for i in range(2):
                gen = torch.Generator().manual_seed(train.step_seed(s, i))
                b = train._draw_batch(gen, cfg.batch_size, consts, cfg)
                out = net.forward_train(model, consts, b["image"], cfg.model, train=False)
                gt = smpl_mod.smpl_forward(consts.smpl, b["gt_pose"], b["gt_betas"], impl=cfg.model.smpl_impl)
                per_image += torch.linalg.vector_norm(out["verts"] - gt["verts"], dim=-1).mean(1).tolist()
    sd = float(np.std(per_image))
    print(f"one image's PVE: sd {sd:.5f} over {len(per_image)} images; standard error of a "
          f"{3 * 8 * cfg.batch_size}-image mean {sd / np.sqrt(3 * 8 * cfg.batch_size):.5f}")


def grads() -> None:
    import jax
    import jax.numpy as jnp
    from indirect_learning_pose_shape_tpu import configs as jconfigs
    from indirect_learning_pose_shape_tpu import losses as jlosses
    from indirect_learning_pose_shape_tpu import train as jtrain
    from indirect_learning_pose_shape_tpu.models import encoder as jenc
    from indirect_learning_pose_shape_tpu.models import ief as jief
    from indirect_learning_pose_shape_tpu.models import network as jnet
    from indirect_learning_pose_shape_tpu.utils import assets as jassets
    from indirect_learning_pose_shape_tpu_torch import losses
    from indirect_learning_pose_shape_tpu_torch.models import encoder as enc

    steps, b = 80, 4
    jasset = jassets.synthetic_asset(num_verts=864, seed=1)

    def shrink(preset, jax_side):
        e, i = (jenc, jief) if jax_side else (enc, ief_mod)
        m = preset.model
        raster = dataclasses.replace(m.raster, image_size=64, train_score_dtype="float32")
        port = {} if jax_side else {"raster_impl": "separable"}
        if not jax_side:
            raster = dataclasses.replace(raster, matmul_precision="highest")
        model = dataclasses.replace(
            m, image_size=64, raster=raster, **port,
            encoder=e.EncoderConfig(depth=m.encoder.depth, width=8, fold_bn_eval=True,
                                    compute_dtype=jnp.float32 if jax_side else torch.float32),
            ief=i.IEFConfig(hidden_dims=(1024, 1024), rotation_format=m.ief.rotation_format))
        lw = tuple((k, 3e-3 if k == "shape_reg" else v) for k, v in preset.loss_weights)
        return dataclasses.replace(preset, model=model, batch_size=b, learning_rate=3e-4, lr_schedule="cosine",
                                   warmup_steps=5, num_steps=steps, grad_clip_norm=1.0, loss_weights=lw)

    jcfg, cfg = shrink(jconfigs.PRESETS["config4_r34"], True), shrink(configs.PRESETS["config4_r34"], False)
    model, consts = net.init(jasset, cfg.model, seed=0, device="cpu")
    jts = _reference_side(model, jcfg, jasset)
    jconsts = jnet.build_consts(jasset, jcfg.model)
    jstep = jax.jit(lambda t, x, c: jtrain.train_step(t, x, c, jcfg))
    jgrad = jax.jit(lambda p, s, c, x: jax.value_and_grad(jtrain.loss_and_metrics, has_aux=True)(p, s, c, x, jcfg))

    def port_model():
        sd = convert.jax_to_state_dict(jax.tree.map(np.asarray, jts.params), jax.tree.map(np.asarray, jts.model_state))
        m, _ = net.init(jasset, cfg.model, seed=0, device="cpu")
        m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
        return m

    def norm_err(a, r):
        return float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30))

    for s in range(steps):
        batch = train.make_batch(0, s, b, consts, cfg)
        jb = {k: v.numpy() for k, v in batch.items()}
        if s in (0, 20, 40, steps - 1):
            (_, (jterms, _)), g = jgrad(jts.params, jts.model_state, jconsts, jb)
            m = port_model()
            total, terms = train.loss_and_metrics(m, consts, batch, cfg)
            total.backward()
            want = convert.jax_to_state_dict(jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, jts.model_state))
            errs = {k: norm_err(p.grad.double().numpy(), np.asarray(want[k], np.float64)) for k, p in m.named_parameters()}
            worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
            print(f"state at step {s}: terms (reference, port) "
                  f"{ {k: (round(float(jterms[k]), 5), round(float(terms[k]), 5)) for k in ('total', 'shape_reg', 'pose_reg')} }; "
                  f"worst leaves {[(k, f'{v:.2e}') for k, v in worst]}; IEF leaves "
                  f"{ {k: f'{v:.2e}' for k, v in errs.items() if k.startswith('ief')} }", flush=True)
        jts, _ = jstep(jts, jb, jconsts)

    # The head alone from the same features, at the last state.
    batch = train.make_batch(0, 999, b, consts, cfg)
    jb = {k: v.numpy() for k, v in batch.items()}
    feat, _ = jax.jit(lambda p, s, im: jenc.encoder_apply(p["encoder"], s["encoder"], im, jcfg.model.encoder, True))(
        jts.params, jts.model_state, jb["image"])
    feat = np.asarray(feat)
    names = ("silhouette", "part_labels", "kp2d", "kp_vis")
    w = dict(jcfg.loss_weights)

    def jhead(ief_params, f):
        out = jnet.render_outputs(jnet.head_from_features(ief_params, jconsts, f, jcfg.model), jconsts, jcfg.model,
                                  probs=False)
        return jlosses.total_loss(out, {k: jb[k] for k in names}, w, 64)

    (_, _), (jg_ief, jg_feat) = jax.value_and_grad(jhead, argnums=(0, 1), has_aux=True)(jts.params["ief"], feat)
    m = port_model()
    ft = torch.from_numpy(feat.copy()).requires_grad_(True)
    out = net.render_outputs(net.head_from_features(m.ief, consts, ft, cfg.model), consts, cfg.model, probs=False)
    total, _ = losses.total_loss(out, {k: batch[k] for k in names}, w, 64)
    total.backward()
    errs = {"mean_theta": norm_err(m.ief.mean_theta.grad.numpy(), np.asarray(jg_ief["mean_theta"])),
            "features": norm_err(ft.grad.numpy(), np.asarray(jg_feat))}
    for i, layer in enumerate(m.ief.layers):
        errs[f"layers.{i}.weight"] = norm_err(layer.weight.grad.numpy().T, np.asarray(jg_ief["layers"][i]["w"]))
        errs[f"layers.{i}.bias"] = norm_err(layer.bias.grad.numpy(), np.asarray(jg_ief["layers"][i]["b"]))
    print(f"head alone from the same features: {({k: f'{v:.2e}' for k, v in errs.items()})}")


def main(argv) -> int:
    what = argv[0] if argv else ""
    if what == "ief_bf16":
        ief_mod.ief_apply = _ief_apply_bf16
        _card_run(what)
    elif what == "f32_encoder":
        cfg = rp.recipe_config(RECIPE)
        m = cfg.model
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, encoder=dataclasses.replace(m.encoder, compute_dtype=torch.float32)))
        _card_run(what, cfg)
    elif what == "batch_stats":
        _card_run("running_stats", score_batch_stats=True)
    elif what == "save":
        ts = _card_run("save")
        sd = {k: v.detach().cpu().numpy() for k, v in ts.model.state_dict().items()}
        np.savez_compressed(argv[1], **{k: v.astype(np.float16) if v.dtype == np.float32 else v for k, v in sd.items()})
    elif what == "adam":
        adam()
    elif what == "stream":
        stream()
    elif what == "evaluators":
        evaluators(argv[1])
    elif what == "grads":
        grads()
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in ("stream", "evaluators", "grads"):
        import conftest  # noqa: F401  (JAX on the CPU)
    sys.exit(main(sys.argv[1:]))
