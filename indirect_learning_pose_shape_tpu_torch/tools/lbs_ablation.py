"""Where the LBS kernel's time goes: variants of `csrc/lbs.cu`, each with one
part taken out, built into a library of its own and timed on the card.

    python -m indirect_learning_pose_shape_tpu_torch.tools.lbs_ablation \\
        [--batches 1 32 128] [--out lbs_ablation.json]

The variants are text substitutions on the kernel's source; every one but
`kernel` computes wrong numbers on purpose:

- `kernel`: the kernel as it is (checked against the plain version);
- `no_skinning`: the epilogue's loop over joints removed (T = 0);
- `no_copies`: no global -> shared copies (the blend reads stale shared memory);
- `no_shared_loads`: the blend's coefficients and basis values made in
  registers instead of read from shared memory;
- `fma_only`: all three removed: the blend's FMAs, the pipeline's barriers,
  the rigid-row staging and the stores are left;
- `timeline`, `fma_only_timeline`: the kernel and `fma_only` with
  global-timer stamps per block, written to a scratch buffer, for the time
  from a block's start to its first chunk, the blend loop and the epilogue.

Each runs at the wrapper's launch plan for each batch, without residuals, on
the SMPL-sized asset. Time per call: warm (calls captured in a CUDA graph
and replayed; the basis stays in L2) and cold (each call after a 128 MB
write, whose own time is subtracted), both by `tools/timing.py`. Needs one CUDA device and nvcc;
writes the JSON to `--out` and prints it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build, lbs_cuda
from indirect_learning_pose_shape_tpu_torch.tools.profile_serve import smi_line
from indirect_learning_pose_shape_tpu_torch.tools.timing import ColdTimer
from indirect_learning_pose_shape_tpu_torch.utils import assets

_NO_SKIN = ("for (int j = 0; j < a.J; ++j) {", "for (int j = 0; j < 0; ++j) {")
_NO_COPY = [
    ("      cp_async16(stage + (c * kKC + k) * kVT + 4 * q,",
     "      if (a.B < 0) cp_async16(stage + (c * kKC + k) * kVT + 4 * q,"),
    ("      cp_async4(sc + (i / IPT) * kGS + (i % IPT) * kCS,",
     "      if (a.B < 0) cp_async4(sc + (i / IPT) * kGS + (i % IPT) * kCS,"),
]
_NO_LDS = [
    ("cf[i] = *reinterpret_cast<const float4*>(sc + i * kCS + k4);",
     "cf[i] = make_float4(i, ch, k4, 1.f);"),
    ("            const float2 bv =\n"
     "                *reinterpret_cast<const float2*>(sb + (c * kKC + k4 + kk) * kVT + 2 * tx);",
     "            const float2 bv = make_float2(c + kk, ch + tx);"),
]


def _stamp(slot: int) -> str:
    return (
        "{ unsigned long long tv; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tv)); "
        "if (threadIdx.x == 0) reinterpret_cast<unsigned long long*>(a.vposed)"
        f"[(blockIdx.y * gridDim.x + blockIdx.x) * 4 + {slot}] = tv; }}"
    )


_TIMELINE = [
    ("  const int tx = threadIdx.x % kTX, ty", f"  {_stamp(0)}\n  const int tx = threadIdx.x % kTX, ty"),
    ("    cp_async_wait<kStages - 2>();\n    __syncthreads();",
     f"    cp_async_wait<kStages - 2>();\n    __syncthreads();\n    if (ch == 0) {_stamp(1)}"),
    ("  load_rel<IPT>(a, slots[0], rs, b0, 0);", f"  {_stamp(2)}\n  load_rel<IPT>(a, slots[0], rs, b0, 0);"),
    ("    __syncthreads();  // slot (i & 1) is refilled next\n  }\n}",
     f"    __syncthreads();  // slot (i & 1) is refilled next\n  }}\n  {_stamp(3)}\n}}"),
]

VARIANTS = {
    "kernel": [],
    "no_skinning": [_NO_SKIN],
    "no_copies": _NO_COPY,
    "no_shared_loads": _NO_LDS,
    "fma_only": [_NO_SKIN, *_NO_COPY, *_NO_LDS],
    "timeline": _TIMELINE,
    "fma_only_timeline": [_NO_SKIN, *_NO_COPY, *_NO_LDS, *_TIMELINE],
}


def build_variants(tmp: Path) -> dict:
    """Each variant's entry point `ilps_lbs_forward`, from one nvcc each."""
    src = (_build.CSRC_DIR / "lbs.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel's source no longer has {old!r}")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(tmp / f"{name}.so"),
               str(tmp / f"{name}.cu")]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (cmd, proc) in procs.items():
        _build._run(cmd, proc)
        fn = ctypes.CDLL(str(tmp / f"{name}.so")).ilps_lbs_forward
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 32, 128])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lbs_ablation: no CUDA device found")
    torch.backends.cuda.matmul.allow_tf32 = False

    consts = smpl.smpl_consts(assets.load_asset(), device="cuda")
    Vp, J = consts.num_verts_padded, consts.num_joints
    kbp, kpp = lbs_cuda._padded_rows(consts)
    timer = ColdTimer(replays=20, calls=10)
    rng = np.random.RandomState(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp))
        for B in args.batches:
            betas = torch.tensor(rng.randn(B, consts.num_betas).astype(np.float32), device="cuda")
            pf = torch.tensor(rng.randn(B, (J - 1) * 9).astype(np.float32) * 0.3, device="cuda")
            rel = torch.tensor(rng.randn(B, J, 12).astype(np.float32), device="cuda")
            want = lbs_cuda.lbs_planar_torch(consts, betas, pf, rel)[0]
            ipt, b_tiles, v_tiles = lbs_cuda.launch_plan(B, Vp)
            verts = torch.empty(B, 3, Vp, device="cuda")
            scratch = torch.zeros(b_tiles * v_tiles * 4, dtype=torch.int64, device="cuda")
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(betas.data_ptr(), pf.data_ptr(), rel.data_ptr(),
                             consts.v_template_p.data_ptr(), consts.shapedirs_p.data_ptr(),
                             consts.posedirs_p.data_ptr(), consts.weights_p.data_ptr(),
                             verts.data_ptr(), scratch.data_ptr(), None,
                             B, Vp, consts.num_betas, kbp, (J - 1) * 9, kpp, J,
                             ipt, b_tiles, v_tiles, 0, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"lbs variant {name}: CUDA error {err}")

                row = {"variant": name, "B": B, "ipt": ipt, "blocks": b_tiles * v_tiles}
                call()
                torch.cuda.synchronize()
                if name == "kernel":
                    row["max_abs_err"] = float((verts - want).abs().max())
                if name.endswith("timeline"):
                    t = scratch.reshape(-1, 4).double().cpu().numpy() / 1e3  # us
                    phases = np.diff(t, axis=1)
                    row.update(
                        span_us=float(t[:, 3].max() - t[:, 0].min()),
                        to_first_chunk_us=float(phases[:, 0].mean()),
                        blend_us=float(phases[:, 1].mean()), blend_max_us=float(phases[:, 1].max()),
                        epilogue_us=float(phases[:, 2].mean()),
                    )
                else:
                    row["ms"], row["cold_ms"] = timer.warm_ms(call), timer.cold_ms(call)
                rows.append(row)
                print(json.dumps(row), flush=True)
    out = {"device": smi_line(), "flush_ms": timer.flush_ms, "rows": rows}
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
