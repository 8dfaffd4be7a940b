"""Post-training int8 quantization of the encoder (port of models/quantize.py).

The reference's scheme, static and symmetric:

- BatchNorm folded into each conv at running statistics (`fold_bn`, float32
  via `BatchNorm.affine`), so each site is conv -> bias -> (relu / add).
  Sites are named 'stem' and 's{stage}b{block}/{conv1|conv2|conv3|proj}'.
- Weights: per-output-channel symmetric int8, scale = absmax / 127 over
  [kh, kw, cin]; the stem's weight is stored in the space-to-depth 4x4x12xC
  layout (inputs must have even H and W).
- Activations: per-tensor symmetric int8, scale = absmax / 127 of each
  conv's input in the folded float32 network over a calibration batch
  (`calibrate`, TF32 off).

Four impls, as the reference's:

- 'int8': every conv quantizes its float32 input, runs int8 x int8 -> int32
  and rescales; float32 between convs (residual adds, ReLU, pools).
- 'int8c': activations carried int8 across layers: each conv's epilogue
  requantizes to its consumer's scale; residual adds and the final pool stay
  float32.
- 'sim' / 'simc': the same rounding with the conv in float32 on dequantized
  values; equal to 'int8' / 'int8c' up to float32 summation rounding.

The int8 product is a library call, as the reference's is an XLA
convolution with int32 accumulation: an im2col of the int8 NHWC
activations (a strided `unfold` view, copied once in [kh, kw, cin] order,
HWIO's) times the [cout, K] weight through `torch._int_mm` (cuBLASLt on
the card's int8 tensor cores; exact int32 sums on every device). On CUDA
`_int_mm` asks for more than 16 rows: a smaller product is padded with zero
rows. Max-pool on int8 is a max over the same strided view (exact: it
commutes with the monotone requantization).

Rounding follows the reference bit for bit: `torch.round` (half to even,
as `jnp.round`) of `x / scale` (a division), the rescale as
`acc.float() * (s_x * w_scale)` with that product formed once, and sites
kept in bf16 (`keep_sites`) run a bf16 convolution whose output is rounded
to bf16 before it is widened.

`QuantizedEncoder` holds a qparams dict on a device as buffers, with the
per-impl products derived once; `quantized_encoder_apply` and
`quantized_forward` take either. The `.npz` format (`save_qparams`,
`load_qparams`) is the reference's: `site::field`, HWIO int8 weights,
`w_bf16` stored as float32, so a file written by either package loads in
the other.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief as ief_mod
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib
from indirect_learning_pose_shape_tpu_torch.utils.precision import full_f32

IMPLS = ("int8", "sim", "int8c", "simc")
FIELDS = ("w", "w_scale", "bias", "act_scale")
_QMAX = 127.0
_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


# ---------------------------------------------------------------------------
# BN folding, layouts
# ---------------------------------------------------------------------------


def _conv_names(block: enc.Block) -> list[tuple[str, str]]:
    names = [("conv1", "bn1"), ("conv2", "bn2")]
    if block.bottleneck:
        names.append(("conv3", "bn3"))
    if block.has_proj:
        names.append(("proj", "bn_proj"))
    return names


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


@torch.no_grad()
def fold_bn(encoder: enc.Encoder) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Folded eval-mode conv sites: {site: (HWIO weight, bias)}, float32."""
    eps = encoder.cfg.bn_eps

    def site(w, bn):
        inv, shift = bn.affine(eps)
        return (_hwio(w.float()) * inv).contiguous(), shift.float()

    sites = {"stem": site(encoder.stem, encoder.bn_stem)}
    for name in encoder.block_names:
        block = getattr(encoder, name)
        for conv, bn in _conv_names(block):
            sites[f"{name}/{conv}"] = site(getattr(block, conv), getattr(block, bn))
    return sites


def _s2d_input(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth of the stem input [B, H, W, C] -> [B, H/2+3, W/2+3, 4C]
    (pad 4 before and 2 after, as the reference's `_s2d_input`)."""
    xp = F.pad(x, (0, 0, 4, 2, 4, 2))
    B, H, W, C = xp.shape
    return (
        xp.reshape(B, H // 2, 2, W // 2, 2, C)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(B, H // 2, W // 2, 4 * C)
    )


def _s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """7x7 HWIO stem kernel -> 4x4 over 4·Cin (zero row and column in front)."""
    cin, c = w.shape[2], w.shape[3]
    w8 = F.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))
    return w8.reshape(4, 2, 4, 2, cin, c).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * cin, c)


def _conv_float(x: torch.Tensor, w_oihw: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """NHWC convolution in x's floating type (cuDNN on the card)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _conv_int8(x: torch.Tensor, w_nk: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """int8 NHWC x, int8 weight [cout, k·k·cin] ([kh, kw, cin] order) ->
    int32 NHWC sums: im2col, then `torch._int_mm`."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    if k == 1:
        cols = x[:, ::stride, ::stride, :] if stride > 1 else x
        B, Ho, Wo, C = cols.shape
        a = cols.reshape(B * Ho * Wo, C)
    else:
        patches = x.unfold(1, k, stride).unfold(2, k, stride)  # [B, Ho, Wo, C, kh, kw]
        B, Ho, Wo = patches.shape[:3]
        a = patches.permute(0, 1, 2, 4, 5, 3).reshape(B * Ho * Wo, -1)
    m = a.shape[0]
    if a.is_cuda and m < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(a.contiguous(), w_nk.t())
    return acc[:m].reshape(B, Ho, Wo, -1)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max-pool with pad 1 on NHWC (torch's alignment); an integer
    tensor pads with its type's minimum, as the reference's `_max_pool_int8`."""
    low = float("-inf") if x.is_floating_point() else torch.iinfo(x.dtype).min
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=low)
    return xp.unfold(1, 3, 2).unfold(2, 3, 2).amax(dim=(-2, -1))


def _requant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -_QMAX, _QMAX)


def _check_even(x: torch.Tensor) -> None:
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(
            f"int8 serving path requires even input H, W (got {x.shape[1]}x{x.shape[2]})"
        )


# ---------------------------------------------------------------------------
# Calibration and quantization
# ---------------------------------------------------------------------------


def _walk(images: torch.Tensor, cfg: enc.EncoderConfig, has_proj, conv_op) -> torch.Tensor:
    """The ResNet topology (eval mode) with `conv_op(x, site, stride, stem)`
    supplying every conv + bias; NHWC float32 -> features [B, D]."""
    bottleneck = cfg.depth >= 50
    x = F.relu(conv_op(images.float(), "stem", 2, True))
    x = _max_pool(x)
    for stage, n in enumerate(enc._STAGE_BLOCKS[cfg.depth]):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            name = f"s{stage}b{b}"
            shortcut = conv_op(x, f"{name}/proj", stride, False) if has_proj(name) else x
            if bottleneck:
                y = F.relu(conv_op(x, f"{name}/conv1", 1, False))
                y = F.relu(conv_op(y, f"{name}/conv2", stride, False))
                y = conv_op(y, f"{name}/conv3", 1, False)
            else:
                y = F.relu(conv_op(x, f"{name}/conv1", stride, False))
                y = conv_op(y, f"{name}/conv2", 1, False)
            x = F.relu(y + shortcut)
    return torch.mean(x, dim=(1, 2))


@torch.no_grad()
def calibrate(folded: dict, images: torch.Tensor, cfg: enc.EncoderConfig):
    """The folded float32 forward (TF32 off): (features, {site: input absmax})."""
    absmax = {}

    def conv_op(x, site, stride, stem):
        absmax[site] = x.abs().amax()
        w, b = folded[site]
        if stem and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            y = _conv_float(_s2d_input(x), _oihw(_s2d_kernel(w)), 1, 0)
        else:
            y = _conv_float(x, _oihw(w), stride, (w.shape[0] - 1) // 2)
        return y + b

    with full_f32():
        feat = _walk(images, cfg, lambda n: f"{n}/proj" in folded, conv_op)
    return feat, absmax


def _quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an HWIO weight: (int8, scale [cout])."""
    s = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12) / _QMAX
    return torch.clamp(torch.round(w / s), -_QMAX, _QMAX).to(torch.int8), s


def _site_kept(site: str, keep_sites) -> bool:
    """True if `site` matches a keep pattern: its name or a prefix ('stem',
    's3' for every stage-3 conv)."""
    return any(site == p or site.startswith(p) for p in keep_sites)


@torch.no_grad()
def ptq_quantize(
    encoder: enc.Encoder, calib_images: torch.Tensor, keep_sites: tuple = ()
) -> dict[str, dict[str, torch.Tensor]]:
    """Calibrate and quantize: {site: {'w': int8 HWIO, 'w_scale': [cout],
    'bias': [cout], 'act_scale': scalar}} on the encoder's device; sites
    matching `keep_sites` also store 'w_bf16' (the folded weight in bf16)
    and run in bf16. A pattern that matches no site is refused."""
    folded = fold_bn(encoder)
    unmatched = [p for p in keep_sites if not any(_site_kept(s, (p,)) for s in folded)]
    if unmatched:
        raise ValueError(
            f"keep_sites patterns {unmatched} match no encoder site; sites are {sorted(folded)}"
        )
    device = encoder.stem.device
    _, absmax = calibrate(folded, torch.as_tensor(calib_images, device=device), encoder.cfg)
    qparams = {}
    for site, (w, b) in folded.items():
        if site == "stem":
            w = _s2d_kernel(w)
        wq, ws = _quantize_weight(w)
        qparams[site] = {
            "w": wq,
            "w_scale": ws,
            "bias": b,
            "act_scale": torch.clamp_min(absmax[site], 1e-12) / _QMAX,
        }
        if _site_kept(site, keep_sites):
            qparams[site]["w_bf16"] = w.to(torch.bfloat16)
    return qparams


# ---------------------------------------------------------------------------
# The quantized encoder
# ---------------------------------------------------------------------------


class _Site(nn.Module):
    """One conv site's tensors: the int8 weight as [cout, K] for `_int_mm`,
    its scale, `out_scale` = act_scale · w_scale, and the bf16 weight (OIHW)
    when kept."""

    def __init__(self, q: dict):
        super().__init__()
        w = q["w"]
        self.k = int(w.shape[0])
        self.kept = "w_bf16" in q
        self.register_buffer("w_nk", w.reshape(-1, w.shape[3]).t().contiguous())
        self.register_buffer("w_scale", q["w_scale"].float())
        self.register_buffer("out_scale", q["act_scale"] * q["w_scale"])
        self.register_buffer("bias", q["bias"].float())
        self.register_buffer("act_scale", q["act_scale"].float())
        if self.kept:
            self.register_buffer("w_bf16", _oihw(q["w_bf16"].to(torch.bfloat16)))

    def w_dq(self) -> torch.Tensor:
        """The dequantized weight, OIHW float32 ('sim' and 'simc')."""
        n, k = self.w_nk.shape[0], self.k
        w = self.w_nk.reshape(n, k, k, -1).permute(0, 3, 1, 2)
        return (w.float() * self.w_scale[:, None, None, None]).contiguous()


def site_conv(q: _Site, x: torch.Tensor, stride: int, stem: bool, impl: str) -> torch.Tensor:
    """One conv site of the per-site path: float32 NHWC x -> conv + bias,
    float32. impl 'int8' quantizes x and runs the int8 product, 'sim' its
    float32 twin on the same rounded values; a bf16-kept site runs in bf16
    either way. The stem goes through space-to-depth."""
    if stem:
        _check_even(x)
        x, stride, pad = _s2d_input(x), 1, 0
    else:
        pad = (q.k - 1) // 2
    if q.kept:  # bf16 site: no weight or activation rounding
        return _conv_float(x.to(torch.bfloat16), q.w_bf16, stride, pad).float() + q.bias
    xq = _requant(x, q.act_scale)
    if impl == "int8":
        y = _conv_int8(xq.to(torch.int8), q.w_nk, q.k, stride, pad).float() * q.out_scale
    else:
        y = _conv_float(xq * q.act_scale, q.w_dq(), stride, pad)
    return y + q.bias


class QuantizedEncoder(nn.Module):
    """A qparams dict as a module (buffers; `.to(device)` moves it):
    `forward(images, impl)` -> features [B, D] float32."""

    def __init__(self, qparams: dict, cfg: enc.EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.site_names = list(qparams)
        self.sites = nn.ModuleDict({s.replace("/", "_"): _Site(q) for s, q in qparams.items()})

    def site(self, name: str) -> _Site:
        return self.sites[name.replace("/", "_")]

    def has(self, name: str) -> bool:
        return name.replace("/", "_") in self.sites

    def forward(self, images: torch.Tensor, impl: str = "int8") -> torch.Tensor:
        if impl in ("int8c", "simc"):
            return self._carried(images, impl)
        if impl not in ("int8", "sim"):
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        return self.walk(images, lambda x, site, stride, stem: site_conv(self.site(site), x, stride, stem, impl))

    def walk(self, images: torch.Tensor, conv_op) -> torch.Tensor:
        """The per-site topology over this encoder's sites, `conv_op(x, site,
        stride, stem)` supplying each conv + bias."""
        return _walk(images, self.cfg, lambda n: self.has(f"{n}/proj"), conv_op)

    def _carried(self, images: torch.Tensor, impl: str) -> torch.Tensor:
        """Activations carried as (tensor, real): real means true float32
        values (feeding a bf16 site, no rounding); otherwise int8-valued at
        the consumer site's act_scale (int8 for 'int8c', float for 'simc')."""
        int8_convs = impl == "int8c"

        def requant(y, site):
            q = self.site(site)
            if q.kept:
                return y, True
            y = _requant(y, q.act_scale)
            return (y.to(torch.int8) if int8_convs else y), False

        def conv(x, real, site, stride, pad):
            q = self.site(site)
            if q.kept:
                xf = x if real else x.float() * q.act_scale
                return _conv_float(xf.to(torch.bfloat16), q.w_bf16, stride, pad).float() + q.bias
            if real:
                x = _requant(x, q.act_scale)
                if int8_convs:
                    x = x.to(torch.int8)
            if int8_convs:
                y = _conv_int8(x, q.w_nk, q.k, stride, pad).float() * q.out_scale
            else:
                y = _conv_float(x * q.act_scale, q.w_dq(), stride, pad)
            return y + q.bias

        def pad(site):
            return (self.site(site).k - 1) // 2

        x = images.float()
        _check_even(x)
        names = [f"s{s}b{b}" for s, n in enumerate(enc._STAGE_BLOCKS[self.cfg.depth]) for b in range(n)]
        bottleneck = self.cfg.depth >= 50
        y = F.relu(conv(_s2d_input(x), True, "stem", 1, 0))
        xq, real = requant(y, f"{names[0]}/conv1")
        xq = _max_pool(xq)
        for i, name in enumerate(names):
            stage, b = int(name[1]), int(name.split("b")[-1])
            stride = 2 if (b == 0 and stage > 0) else 1
            if self.has(f"{name}/proj"):
                # proj's calibrated input scale equals conv1's (same tensor).
                shortcut = conv(xq, real, f"{name}/proj", stride, pad(f"{name}/proj"))
            else:
                shortcut = xq if real else xq.float() * self.site(f"{name}/conv1").act_scale
            if bottleneck:
                h = F.relu(conv(xq, real, f"{name}/conv1", 1, pad(f"{name}/conv1")))
                h, hr = requant(h, f"{name}/conv2")
                h = F.relu(conv(h, hr, f"{name}/conv2", stride, pad(f"{name}/conv2")))
                h, hr = requant(h, f"{name}/conv3")
                yb = conv(h, hr, f"{name}/conv3", 1, pad(f"{name}/conv3"))
            else:
                h = F.relu(conv(xq, real, f"{name}/conv1", stride, pad(f"{name}/conv1")))
                h, hr = requant(h, f"{name}/conv2")
                yb = conv(h, hr, f"{name}/conv2", 1, pad(f"{name}/conv2"))
            out = F.relu(yb + shortcut)
            if i + 1 < len(names):
                xq, real = requant(out, f"{names[i + 1]}/conv1")
        return torch.mean(out, dim=(1, 2))


def as_encoder(qparams, cfg: enc.EncoderConfig, device=None) -> QuantizedEncoder:
    """`qparams` as a `QuantizedEncoder` on `device` (one already built is
    moved, not rebuilt)."""
    qenc = qparams if isinstance(qparams, QuantizedEncoder) else QuantizedEncoder(qparams, cfg)
    return qenc.to(device) if device is not None else qenc


def quantized_encoder_apply(
    qparams, images: torch.Tensor, cfg: enc.EncoderConfig, impl: str = "int8"
) -> torch.Tensor:
    """images [B, H, W, 3] float32 (even H, W) -> features [B, D] float32."""
    return as_encoder(qparams, cfg, images.device)(images, impl)


def quantized_forward(
    qparams,
    ief: ief_mod.IEF,
    consts: net.ModelConsts,
    images: torch.Tensor,
    cfg: net.ModelConfig,
    impl: str = "int8",
    mesh=None,
) -> dict[str, torch.Tensor]:
    """images -> `network.forward`'s outputs through the quantized encoder;
    the head (IEF, SMPL through `cfg.smpl_impl`, projection) as the float
    path's `network.head_from_features`.

    Under a data mesh (`parallel/mesh.py`) `images` is the whole request on
    every rank, qparams and `ief` replicated (the same file, or
    `mesh.replicate`): each rank runs its rows (`mesh.batch_rows`; a batch
    the data axis does not divide is refused) and every rank returns the
    whole batch's outputs (`mesh.gather_rows`)."""
    if mesh is not None:
        out = quantized_forward(qparams, ief, consts, images[mesh.batch_rows(images.shape[0])], cfg, impl)
        return {k: mesh_lib.gather_rows(v, mesh) for k, v in out.items()}
    feat = quantized_encoder_apply(qparams, images, cfg.encoder, impl)
    return net.head_from_features(ief, consts, feat, cfg)


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def save_qparams(path: str, qparams: dict) -> None:
    """One .npz of `site::field` arrays ('w_bf16' as float32: npz has no bf16)."""
    flat = {}
    for site, q in qparams.items():
        for field, v in q.items():
            v = v.detach().cpu()
            flat[f"{site}::{field}"] = (v.float() if field == "w_bf16" else v).numpy()
    np.savez(path, **flat)


def load_qparams(path: str) -> dict[str, dict[str, torch.Tensor]]:
    """The inverse of `save_qparams` (CPU tensors). Refuses a site missing a
    field and a weight that is not int8."""
    qparams: dict = {}
    with np.load(path) as z:
        for key in z.files:
            site, field = key.split("::", 1)
            v = torch.from_numpy(np.array(z[key]))
            if field == "w_bf16":
                v = v.to(torch.bfloat16)
            qparams.setdefault(site, {})[field] = v
    for site, q in qparams.items():
        missing = set(FIELDS) - set(q)
        if missing:
            raise ValueError(f"qparams site {site!r} missing fields {sorted(missing)}")
        if q["w"].dtype != torch.int8:
            raise ValueError(f"qparams site {site!r} weight dtype {q['w'].dtype}, want int8")
    return qparams
