"""Smoke run of the swift_torch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each printed as it finishes:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles the CUDA kernels from ``swift_torch/csrc`` with nvcc;
3. kernels: each of the five kernels against its plain PyTorch version at
   the flagship's shapes (B=2, 64x128 tokens, dim 1056, heads 12x88 and
   8x128, window shift (0,0) and (8,8)), bf16 inputs from a numpy seed;
   fails when max|kernel - plain| exceeds 2e-2 of max|plain|; prints both
   times (CUDA events, median of 20 launches);
4. slice: the flagship 1-step sCM ensemble forecast at full width (12
   layers, dim 1056, 12x88 heads, 128x256 grid, 69+3 channels) with random
   weights saved and reloaded through the port's checkpoint files, rolled
   out by ``swift_torch.generate.rollout_to_store`` over an in-memory
   synthetic dataset into a WB2-layout zarr store, in two segments of two
   steps (the second computes while the first is written). Checks that every kernel
   launched during the rollout, that the store is finite and not constant,
   and that a depth-2 cut of the same network agrees with the plain
   PyTorch path on the CPU. Prints forecast steps/s, end to end and for
   the network's forward alone. Fails if any JAX module was loaded.

The last lines are the per-kernel JSON record and the contract line
``{"ok": true, "device": {...}}``. There is no CPU path: without CUDA, or
when a build, launch or check fails, the script raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from swift_torch import factory
from swift_torch.data.synthetic import SyntheticERA5
from swift_torch.generate import read_store, rollout_to_store
from swift_torch.ops import _build
from swift_torch.ops.block_attention import (
    fused_block_attention,
    reference_block_attention,
)
from swift_torch.ops.ffn import fused_swiglu_ffn, reference_swiglu_ffn
from swift_torch.ops.linear import fused_linear, reference_linear
from swift_torch.ops.modnorm import (
    fused_matmul_modnorm_residual,
    fused_modnorm_residual,
    reference_matmul_modnorm_residual,
    reference_modnorm_residual,
)
from swift_torch.sampling.factory import sampler_factory
from swift_torch.utils.checkpoint import load_checkpoint, save_checkpoint

ROOT = os.path.dirname(os.path.abspath(__file__))

TOL = 2e-2  # max|kernel - plain| / max|plain|, bf16 rounding of outputs and p
GRID = (64, 128)  # flagship token grid: 128x256 at patch 2
DIM, HIDDEN = 1056, 2816
GEOMETRIES = ((12, 88), (8, 128))  # (heads, head dim): parity and hd128
SHIFTS = ((0, 0), (8, 8))

# swift_tpu/configs/experiment/era5-swinv2-1.4-scm.yaml over data/era5-flare-1.4.yaml
SURFACE = ["2m_temperature", "10m_u_component_of_wind", "10m_v_component_of_wind",
           "mean_sea_level_pressure"]
LEVEL_VARS = ["geopotential", "u_component_of_wind", "v_component_of_wind", "temperature",
              "specific_humidity"]
LEVELS = [50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000]  # hPa
VARIABLES = SURFACE + [f"{v}_{lev}" for v in LEVEL_VARS for lev in LEVELS]
FORCINGS = ["toa_incident_solar_radiation", "geopotential_at_surface", "land_sea_mask"]
RESOLUTION = (128, 256)
MODEL = {"_target_": "SwinV2", "window_size": [16, 16], "shift_size": [8, 8],
         "patch_size": [2, 2], "depth": 12, "dim": DIM, "heads": 12, "logvar": True}
PRECOND = {"_target_": "PassPrecond", "auxiliary_dim": 1, "sigma_data": 1.0}
ROLLOUT = dict(members=2, batch=2, samples=2, steps=4, interval=6, segment=2, seed=0,
               solver="scm", num_solver_steps=1, dump="zarr")
SLICE_TOL = 5e-2  # bf16 kernels vs the fp32 plain path through two full-width blocks
WORK = os.path.join(ROOT, ".smoke")  # git-ignored; removed at the end

KERNELS = {
    # name: (wrapper, plain version, route, source, TPU kernel it replaces)
    "linear": (fused_linear, reference_linear, "cuda", "swift_torch/csrc/gemm.cu",
               "swift_tpu/ops/pallas_linear.py:36"),
    "block_attention": (fused_block_attention, reference_block_attention, "cuda",
                        "swift_torch/csrc/block_attention.cu",
                        "swift_tpu/ops/pallas_block_attention.py:264"),
    "matmul_modnorm_residual": (fused_matmul_modnorm_residual,
                                reference_matmul_modnorm_residual, "cuda",
                                "swift_torch/csrc/gemm.cu",
                                "swift_tpu/ops/pallas_modnorm.py:271"),
    "modnorm_residual": (fused_modnorm_residual, reference_modnorm_residual, "triton",
                         "swift_torch/ops/modnorm.py", "swift_tpu/ops/pallas_modnorm.py:56"),
    "swiglu_ffn": (fused_swiglu_ffn, reference_swiglu_ffn, "cuda", "swift_torch/csrc/ffn.cu",
                   "swift_tpu/ops/pallas_ffn.py:68"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {card}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    path, compile_s, report = _build.build()
    _build.library()
    log(f"[build] {path.relative_to(ROOT)}: compiled in {compile_s:.1f} s "
        f"(load {time.perf_counter() - t0 - compile_s:.2f} s)")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one call, CUDA events around each."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _inputs(rng: np.random.Generator, heads: int, d: int, B: int = 2) -> dict:
    gh, gw = GRID
    T = B * gh * gw
    inner = heads * d

    def t(shape, scale=1.0, dtype=torch.bfloat16):
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dtype)

    return {
        "x": t((T, DIM)),
        "w_qkv": t((3 * inner, DIM), DIM ** -0.5),
        "qkv": t((B, gh, gw, 3 * inner)),
        "scale": torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0)),
        "attn": t((B, gh, gw, inner)),
        "w_o": t((DIM, inner), inner ** -0.5),
        "y": t((B, gh, gw, DIM), 3.0),
        "r": t((B, gh, gw, DIM)),
        "g": 1.0 + t((DIM,), 0.1, torch.float32),
        "b": t((DIM,), 0.1, torch.float32),
        "msc": t((B, DIM), 0.2),
        "msh": t((B, DIM), 0.2),
        "w1": t((2 * HIDDEN, DIM), DIM ** -0.5),
        "w2": t((DIM, HIDDEN), HIDDEN ** -0.5),
    }


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the per-kernel record."""
    rng = np.random.default_rng(0)
    record: dict = {}
    for heads, d in GEOMETRIES:
        a = _inputs(rng, heads, d)
        cases = [
            ("linear", (a["x"], a["w_qkv"]), {}),
            ("matmul_modnorm_residual",
             (a["attn"], a["w_o"], a["r"], a["g"], a["b"], a["msc"], a["msh"]), {}),
        ] + [
            ("block_attention", (a["qkv"], a["scale"], heads, (16, 16), s), {"shift": s})
            for s in SHIFTS
        ]
        if d == GEOMETRIES[0][1]:  # these two do not depend on the head layout
            cases += [
                ("modnorm_residual", (a["y"], a["r"], a["g"], a["b"], a["msc"], a["msh"]), {}),
                ("swiglu_ffn", (a["x"], a["w1"], a["w2"]), {}),
            ]
        for name, args, tags in cases:
            fused, plain = KERNELS[name][:2]
            got = fused(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) and err <= TOL * ref
            ms = time_ms(lambda: fused(*args))
            plain_ms = time_ms(lambda: plain(*args))
            log(f"[kernels] {name:24s} heads={heads:2d} d={d:3d} {tags or ''} "
                f"max_abs_err={err:.3e} (ref max {ref:.3e}, rel {err / ref:.2e})  "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"{name} (heads={heads}, d={d}, {tags}) disagrees "
                                     f"with its plain version: {err:.3e} > {TOL} x {ref:.3e}")
            rec = record.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if d == GEOMETRIES[0][1] and tags.get("shift", (8, 8)) == (8, 8):
                rec["ms"], rec["plain_ms"] = ms, plain_ms  # flagship timing of record
    return record


def build_net(depth: int, dtype: torch.dtype):
    return factory.build_precond(PRECOND, {**MODEL, "depth": depth}, RESOLUTION,
                                 len(VARIABLES), len(VARIABLES) + len(FORCINGS), dtype=dtype)


def random_weights(net, seed: int = 0) -> None:
    """0.02·normal for every weight, the zero-initialised modulation and head
    included; LayerNorm scales at 1 + 0.02·normal, logit scales at log 10."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            if name.endswith("norm.norm.weight"):
                p.add_(1.0)
            elif name.endswith(".scale"):
                p.add_(float(np.log(10.0)))


def check_depth2_cut(net) -> float:
    """Relative max error of a depth-2 cut of ``net`` (same widths and
    weights) run through the kernels in bf16 against the plain path in fp32
    on the CPU, for one sCM step on a real-sized input."""
    sd = {k: v for k, v in net.state_dict().items()
          if ".layers." not in k or int(k.split(".layers.")[1].split(".")[0]) < 2}
    gpu, cpu = build_net(2, torch.bfloat16), build_net(2, torch.float32)
    gpu.load_state_dict(sd)
    cpu.load_state_dict(sd)
    rng = np.random.default_rng(1)
    H, W = RESOLUTION
    x = torch.from_numpy(rng.standard_normal((1, H, W, len(VARIABLES)), dtype=np.float32))
    cond = torch.from_numpy(
        rng.standard_normal((1, H, W, len(VARIABLES) + len(FORCINGS)), dtype=np.float32))
    t = torch.tensor([np.pi / 2], dtype=torch.float32)
    with torch.no_grad():
        got = gpu.cuda().eval()(x.cuda(), t, cond.cuda(), 0.6).cpu()
        want = cpu.eval()(x, t, cond, 0.6)
    if not torch.isfinite(got).all():
        raise AssertionError("depth-2 cut: non-finite output from the kernels")
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_slice(card: str) -> dict:
    """The flagship forecast through swift_torch's generate path; returns
    each kernel's launch count in that run."""
    t0 = time.perf_counter()
    net = build_net(MODEL["depth"], torch.bfloat16)
    random_weights(net)
    n_params = sum(p.numel() for p in net.parameters())
    ckpt = os.path.join(WORK, "run", "checkpoints", "checkpoint-000000.npz")
    save_checkpoint(ckpt, net.state_dict(), depth=MODEL["depth"])
    loaded = load_checkpoint(ckpt)
    for k, v in net.state_dict().items():
        if not torch.equal(loaded[k], v):
            raise AssertionError(f"checkpoint round trip changed {k}")
    net.load_state_dict(loaded)
    log(f"[slice] flagship net: {n_params / 1e6:.1f} M params, checkpoint "
        f"{os.path.getsize(ckpt) / 2**20:.0f} MiB written and reloaded "
        f"({time.perf_counter() - t0:.1f} s)")

    rel = check_depth2_cut(net)
    log(f"[slice] depth-2 cut, kernels bf16 vs plain fp32 (CPU): rel max err {rel:.3e}")
    if rel > SLICE_TOL:
        raise AssertionError(f"depth-2 cut disagrees with the plain path: {rel} > {SLICE_TOL}")

    dataset = SyntheticERA5(VARIABLES, FORCINGS, n_files=10, shape=RESOLUTION, seed=0)
    net = net.cuda().eval()
    args = argparse.Namespace(**ROLLOUT)
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
    ofile, wall, n_steps = rollout_to_store(args, dataset, net, os.path.join(WORK, "out"))
    launches = {name: w.launches for name, (w, *_) in KERNELS.items()}
    log(f"[slice] kernel launches in the rollout: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the rollout never launched {missing}")

    store = read_store(ofile)
    n_ic, M, leads = ROLLOUT["samples"], ROLLOUT["members"], ROLLOUT["steps"] + 1
    expected = {v: (n_ic, M, leads) + RESOLUTION for v in SURFACE}
    expected.update({v: (n_ic, M, leads, len(LEVELS)) + RESOLUTION for v in LEVEL_VARS})
    if sorted(store) != sorted(expected):
        raise AssertionError(f"store holds {sorted(store)}, expected {sorted(expected)}")
    for var, a in store.items():
        if a.shape != expected[var]:
            raise AssertionError(f"store {var}: shape {a.shape}, expected {expected[var]}")
        if not np.isfinite(a).all():
            raise AssertionError(f"store {var}: non-finite values")
        if not a[:, :, 1:].std() > 0:
            raise AssertionError(f"store {var}: forecast leads are constant")
    log(f"[slice] store {os.path.relpath(ofile, ROOT)}: {len(store)} variables finite and "
        f"non-constant, shape (ic, member, lead) = {(n_ic, M, leads)}")
    MB = M * ROLLOUT["batch"]
    log(f"[slice] {n_steps} forecast steps at members x batch = {MB} in "
        f"{wall:.3f} s: {n_steps / wall:.3f} forecast steps/s ({card})")

    # the device's share of that: one sCM step (one network forward) at MB
    sampler = sampler_factory("scm", net, num_steps=1, sigma_min=0.02, sigma_max=200.0,
                              auxiliary=ROLLOUT["interval"] / 10.0)
    cond = torch.randn(MB, *RESOLUTION, len(VARIABLES) + len(FORCINGS), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        step_ms = time_ms(lambda: sampler(cond, gen), reps=5)
    device_s = (n_steps // MB) * step_ms / 1e3  # one sampler call per MB forecast steps
    log(f"[slice] one sCM step at MB={MB}: {step_ms:.2f} ms (median of 5), i.e. "
        f"{MB / step_ms * 1e3:.3f} forecast steps/s on the device alone; the rollout's "
        f"device work is {device_s:.3f} s of its {wall:.3f} s ({card})")
    return launches


def main() -> int:
    card = phase_environment()
    phase_build()
    record = phase_kernels()
    try:
        launches = phase_slice(card)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    jax_modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
    if jax_modules:
        raise AssertionError(f"the port loaded JAX modules: {jax_modules[:5]}")
    kernels = [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches[name], **record[name]}
        for name, (_, _, route, src, rep) in KERNELS.items()
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
