"""Smoke run of the swift_torch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each printed as it finishes:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles the CUDA kernels from ``swift_torch/csrc`` with nvcc;
3. kernels: each of the seventeen kernels (five forward, four for reverse-
   mode training, four forward-mode tangents for the sCM step, four for the
   0.25° grid: the window-tiled attention 15, 16, 17 and the recompute FFN
   backward 10) against its plain PyTorch version at the flagship's shapes
   (B=2, 64x128 tokens, dim 1056, heads 12x88 and 8x128, window shift (0,0)
   and (8,8); the tiled kernels on pre-rolled input), and the 0.25° four
   also at the 0.25° shapes (B=1, 368x720 tokens, 8x128 heads), bf16 inputs
   from a numpy seed; fails when max|kernel - plain| of any output exceeds
   2e-2 of max|plain|, or when kernel 16's scratch exceeds its qkv or kernel
   10's 1 GB at 0.25°; prints both times (CUDA events, median of 20
   launches, 5 at 0.25°), the bound the card could reach from the shapes,
   the scratch of kernels 16 and 10 and, for the qkv projection and its
   primal + tangent, ``F.linear``'s time;
4. slice: the flagship 1-step sCM ensemble forecast at full width (12
   layers, dim 1056, 12x88 heads, 128x256 grid, 69+3 channels) with random
   weights saved and reloaded through the port's checkpoint files, rolled
   out by ``swift_torch.generate.rollout_to_store`` over an in-memory
   synthetic dataset into a WB2-layout zarr store, in two segments of two
   steps. Checks that every forward kernel launched during the rollout,
   that the store is finite and not constant, and that a depth-2 cut of
   the same network agrees with the plain PyTorch path on the CPU. Prints
   forecast steps/s, end to end and for the network's forward alone;
5. train: six full-width steps of ``era5-swinv2-1.4-trigflow`` (config
   composed from the YAML tree, global batch 4, remat, AdamW, EMA) through
   the port's ``Trainer`` over ``SyntheticERA5`` batches from its
   ``BatchLoader``. Fails unless all nine kernels launched, loss and grad
   norm stayed finite and every parameter moved; reloads the final
   checkpoint's EMA into one forecast step; prints launches per step,
   s/step, images/s and TFLOP/s against the bf16 peak, and one more step's
   device time by kernel under ``torch.profiler``;
6. gradient cut: a depth-2 cut of the trained network, loss and every
   parameter's gradient through the kernels in bf16 against the fp32 plain
   path on the CPU;
7. scm: six full-width steps of ``era5-swinv2-1.4-scm``, the default
   experiment (SCMLoss with its jvp forward through the tangent kernels,
   Muon with aux-Adam, EMA, remat), cut like the TrigFlow slice, then one
   step with the tangent warmup at r = 1. Fails unless all thirteen kernels
   launched at the step's exact per-step counts, loss and grad norm stayed
   finite, every parameter moved, and the Muon and Adam groups hold the
   parameters the JAX package's labels give; prints s/step, images/s,
   TFLOP/s, peak memory and one profiled step by kernel;
8. sCM cut: a depth-2 cut of the sCM-trained network, its tangent dF_x and
   then the sCM loss (r = 1) and every gradient at fixed draws through the
   kernels in bf16, against the fp32 plain path on the CPU;
9. quarter forecast: the 0.25° configuration of record
   (``era5-swinv2-0.25-scm``: the 721x1440 grid edge-padded to 736 rows,
   368x720 tokens, 12 x 1056, 8x128 heads, factorized position tables) at
   full width with random weights, 1 member x 1 IC x 2 steps through
   ``rollout_to_store`` into a 721x1440 store; fails unless the store is
   finite and not constant and the attention ran kernel 15 twelve times a
   forward and kernel 2 never; prints the forward's device time;
10. quarter scm: two full-width sCM steps of that experiment at batch 1
   through the ``Trainer`` (Muon + aux-Adam, EMA, remat), then one at r = 1;
   fails unless kernels 10, 15, 16 and 17 launched at the step's exact
   counts and 2, 6, 7, 8 and 9 never, the loss stayed finite and every
   parameter moved; prints s/step, peak memory and one profiled step;
11. quarter cut: two full-width blocks at 368x720, batch 1, fixed draws,
   r = 1: the tangent dF_x, the loss and every gradient through the
   kernels in bf16 against the plain path in fp32, here on the card (the
   CPU cannot run the fp32 plain path at 264,960 tokens in the time limit:
   every wrapper is made to take its plain version for the reference run).

The 1.4° paths launch none of kernels 10 and 15-17. Fails if any module of
jax, flax, optax or swift_tpu was loaded. The last
lines are the per-kernel JSON record and the contract line
``{"ok": true, "device": {...}}``. There is no CPU path: without CUDA, or
when a build, launch or check fails, the script raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from swift_torch import config as cfglib
from swift_torch import factory
from swift_torch.data.pipeline import BatchLoader
from swift_torch.data.samplers import InfiniteSampler
from swift_torch.data.synthetic import SyntheticERA5
from swift_torch.generate import read_store, rollout_to_store
from swift_torch.ops import _build
from swift_torch.ops.block_attention import (
    block_attention_bwd,
    block_attention_tangent,
    fused_block_attention,
    fused_tiled_block_attention,
    reference_block_attention,
    reference_block_attention_bwd,
    reference_block_attention_tangent,
    tiled_block_attention_bwd,
    tiled_block_attention_tangent,
    tiled_bwd_scratch_bytes,
)
from swift_torch.ops.ffn import (
    bwd_recompute_scratch_bytes,
    fused_swiglu_ffn,
    reference_swiglu_ffn,
    reference_swiglu_ffn_bwd_recompute,
    reference_swiglu_ffn_bwd_saved,
    reference_swiglu_ffn_fwd_save,
    reference_swiglu_ffn_pt,
    swiglu_ffn_bwd_recompute,
    swiglu_ffn_bwd_saved,
    swiglu_ffn_fwd_save,
    swiglu_ffn_pt,
)
from swift_torch.ops.linear import (
    fused_linear,
    fused_linear_bwd,
    linear_pt,
    reference_linear,
    reference_linear_bwd,
    reference_linear_pt,
)
from swift_torch.ops.modnorm import (
    fused_matmul_modnorm_residual,
    fused_modnorm_residual,
    modnorm_residual_tangent,
    reference_matmul_modnorm_residual,
    reference_modnorm_residual,
    reference_modnorm_residual_tangent,
)
from swift_torch.sampling.factory import sampler_factory
from swift_torch.training.trainer import Trainer, muon_param_labels, swin_flop_count
from swift_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint

ROOT = os.path.dirname(os.path.abspath(__file__))

TOL = 2e-2  # max|kernel - plain| / max|plain| for every output, bf16 rounding of outputs, p, dS
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: bf16 dense tensor cores, HBM3
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
# the training slice: swift_tpu/configs/experiment/era5-swinv2-1.4-trigflow.yaml (the
# same model as MODEL), global batch 4, 6 AdamW steps, a tick every 2 steps
TRAIN_EXPERIMENT = "era5-swinv2-1.4-trigflow"
TRAIN = dict(batch=4, steps=6, steps_per_tick=2)
# depth-2 gradient cut, |loss bf16 kernels - fp32 plain| / |fp32 plain| and, for every
# parameter, ||grad - grad_plain|| / ||grad_plain||: stated as 5e-2 and 1e-1 before the
# first run, tightened after it read 9.4e-6 and 6.8e-3 (NVIDIA H100 80GB HBM3, 700 W)
CUT_LOSS_TOL = 1e-3
CUT_GRAD_TOL = 3e-2
# the sCM slice: swift_tpu/configs/experiment/era5-swinv2-1.4-scm.yaml (the default
# experiment, the same model as MODEL), cut as TRAIN is
SCM_EXPERIMENT = "era5-swinv2-1.4-scm"
# depth-2 sCM cut: ||dF_x bf16 kernels - fp32 plain|| / ||fp32 plain||, the loss and
# every gradient; stated as 5e-2, 1e-3 and 3e-2 before the first run, tightened after it
# read 1.40e-2, 2.4e-6 and 1.77e-2 (NVIDIA H100 80GB HBM3, 700 W)
SCM_CUT_DF_TOL = 2e-2
SCM_CUT_LOSS_TOL = 1e-4
SCM_CUT_GRAD_TOL = 2.5e-2
# the 0.25° configuration of record: swift_tpu/configs/experiment/era5-swinv2-0.25-scm.yaml
# over data/era5-flare-0.25.yaml (the same 69 + 3 channels as the flagship's data): the WB2
# 721x1440 grid, edge-padded inside the model to 736 rows, so 368x720 tokens; 8 heads x 128,
# factorized position tables. Cut: random weights, synthetic data, batch 1 (as the
# experiment), two steps, lr warmup 0; the forecast 1 member x 1 IC x 2 steps
QUARTER_EXPERIMENT = "era5-swinv2-0.25-scm"
QUARTER_RES = (721, 1440)
QUARTER_GRID = (368, 720)
QUARTER_MODEL = {**MODEL, "heads": 8, "head_dim": 128, "pos_embed_mode": "factorized"}
QUARTER_ROLLOUT = dict(members=1, batch=1, samples=1, steps=2, interval=6, segment=2, seed=0,
                       solver="scm", num_solver_steps=1, dump="zarr")
QUARTER_TRAIN = dict(batch=1, steps=2, steps_per_tick=1)
# depth-2 0.25° sCM cut, kernels bf16 against the plain path fp32 on the card: the tangent
# dF_x (relative L2), the loss and every gradient (relative L2); stated as 5e-2, 1e-3 and
# 3e-2 before the first run, tightened after it read 1.28e-2, 1.0e-6 and 1.42e-2 (NVIDIA
# H100 80GB HBM3, 700 W)
QUARTER_CUT_DF_TOL = 2e-2
QUARTER_CUT_LOSS_TOL = 1e-4
QUARTER_CUT_GRAD_TOL = 2.5e-2
WORK = os.path.join(ROOT, ".smoke")  # git-ignored; removed at the end


@dataclasses.dataclass(frozen=True)
class ScmSlice:
    """An sCM training slice: its experiment and how it is cut, the model it
    must compose to, each kernel's launches per step, and its depth-2 cut's
    batch, limits (dF_x, loss, gradients) and where the fp32 plain path of
    the cut runs."""
    tag: str
    experiment: str
    model: dict
    res: tuple
    cut: dict
    per_step: dict
    n_files: int
    cut_batch: int
    cut_tols: tuple
    plain_on: str  # "CPU", or "card" where the CPU cannot run the cut in time

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
    "block_attention_bwd": (block_attention_bwd, reference_block_attention_bwd, "cuda",
                            "swift_torch/csrc/block_attention.cu",
                            "swift_tpu/ops/pallas_block_attention.py:291"),
    "swiglu_ffn_fwd_save": (swiglu_ffn_fwd_save, reference_swiglu_ffn_fwd_save, "cuda",
                            "swift_torch/csrc/ffn.cu", "swift_tpu/ops/pallas_ffn.py:117"),
    "swiglu_ffn_bwd_saved": (swiglu_ffn_bwd_saved, reference_swiglu_ffn_bwd_saved, "cuda",
                             "swift_torch/csrc/gemm_bwd.cu", "swift_tpu/ops/pallas_ffn.py:199"),
    "linear_bwd": (fused_linear_bwd, reference_linear_bwd, "cuda", "swift_torch/csrc/gemm_bwd.cu",
                   "swift_tpu/ops/pallas_linear.py:84"),
    "linear_pt": (linear_pt, reference_linear_pt, "cuda", "swift_torch/csrc/gemm.cu",
                  "swift_tpu/ops/pallas_linear.py:145"),
    "swiglu_ffn_pt": (swiglu_ffn_pt, reference_swiglu_ffn_pt, "cuda", "swift_torch/csrc/ffn.cu",
                      "swift_tpu/ops/pallas_ffn.py:392"),
    "modnorm_residual_tangent": (modnorm_residual_tangent, reference_modnorm_residual_tangent,
                                 "triton", "swift_torch/ops/modnorm.py",
                                 "swift_tpu/ops/pallas_modnorm.py:202"),
    "block_attention_tangent": (block_attention_tangent, reference_block_attention_tangent,
                                "cuda", "swift_torch/csrc/block_attention.cu",
                                "swift_tpu/ops/pallas_block_attention.py:408"),
    "swiglu_ffn_bwd_recompute": (swiglu_ffn_bwd_recompute, reference_swiglu_ffn_bwd_recompute,
                                 "cuda", "swift_torch/csrc/gemm_bwd.cu",
                                 "swift_tpu/ops/pallas_ffn.py:293"),
    "tiled_block_attention": (fused_tiled_block_attention, reference_block_attention,
                              "cuda", "swift_torch/csrc/block_attention.cu",
                              "swift_tpu/ops/pallas_block_attention.py:655"),
    "tiled_block_attention_bwd": (tiled_block_attention_bwd, reference_block_attention_bwd,
                                  "cuda", "swift_torch/csrc/block_attention.cu",
                                  "swift_tpu/ops/pallas_block_attention.py:743"),
    "tiled_block_attention_tangent": (tiled_block_attention_tangent,
                                      reference_block_attention_tangent, "cuda",
                                      "swift_torch/csrc/block_attention.cu",
                                      "swift_tpu/ops/pallas_block_attention.py:865"),
}
QUARTER_KERNELS = ("swiglu_ffn_bwd_recompute", "tiled_block_attention", "tiled_block_attention_bwd",
                   "tiled_block_attention_tangent")  # kernels 10, 15, 16, 17
WHOLE_GRID = ("block_attention", "block_attention_bwd", "block_attention_tangent",
              "swiglu_ffn_fwd_save", "swiglu_ffn_bwd_saved")  # kernels 2, 6, 7, 8, 9


def _tokens(t: torch.Tensor) -> int:
    return t.numel() // t.shape[-1]


def kernel_flops(name: str, args) -> float:
    """Operations each kernel's function needs at these shapes (matrix
    products at 2 per multiply-add; the epilogues' ~10 per element)."""
    if name == "linear":
        x, w = args
        return 2.0 * _tokens(x) * w.shape[0] * w.shape[1]
    if name in ("linear_bwd", "linear_pt"):
        x, w = args[1], args[2]
        return 4.0 * _tokens(x) * w.shape[0] * w.shape[1]
    if "block_attention" in name:
        qkv = args[0]
        # QKᵀ, PV | + dV, dP, dQ, dK | tangent: QKᵀ, dQ·Kᵀ, Q·dKᵀ, dP·V, P·dV
        per = 4.0 if name in ("block_attention", "tiled_block_attention") else 10.0
        return per * _tokens(qkv) * 256 * qkv.shape[-1] / 3  # 256 keys a window
    if name == "matmul_modnorm_residual":
        x, w = args[:2]
        return 2.0 * _tokens(x) * w.shape[0] * w.shape[1] + 10.0 * _tokens(x) * w.shape[0]
    if name == "modnorm_residual":
        return 10.0 * args[0].numel()
    if name == "modnorm_residual_tangent":
        return 18.0 * args[0].numel()
    x = args[0]
    T, D, H = _tokens(x), x.shape[-1], args[-1].shape[1]
    matmuls = {"swiglu_ffn_bwd_saved": 6, "swiglu_ffn_pt": 6, "swiglu_ffn_bwd_recompute": 8}
    return 2.0 * matmuls.get(name, 3) * T * D * H


def _nbytes(objs) -> int:
    return sum(t.numel() * t.element_size() for t in objs if isinstance(t, torch.Tensor))


def kernel_bound(name: str, args, out) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the larger of each input read once and
    each output written once at the card's memory rate, and the operations
    at its bf16 dense peak."""
    outs = out if isinstance(out, tuple) else (out,)
    t_bytes = (_nbytes(args) + _nbytes(outs)) / PEAK_BYTES * 1e3
    t_ops = kernel_flops(name, args) / PEAK_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


FORWARD = ("linear", "block_attention", "matmul_modnorm_residual", "modnorm_residual",
           "swiglu_ffn")  # the forecast runs these
TRIGFLOW = FORWARD + ("block_attention_bwd", "swiglu_ffn_fwd_save", "swiglu_ffn_bwd_saved",
                      "linear_bwd")  # the TrigFlow step; the sCM step runs all of KERNELS
# launches of one sCM step (the JAX launch pattern at the flagship grid): the jvp
# forward's 12 blocks (kernels 14, 2, 7, 4 and 12 twice, 11), then the TrigFlow step's
# first forward, remat recompute and backward
SCM_PER_STEP = {
    "linear": 24, "block_attention": 36, "matmul_modnorm_residual": 24, "modnorm_residual": 48,
    "swiglu_ffn": 12, "block_attention_bwd": 12, "swiglu_ffn_fwd_save": 12,
    "swiglu_ffn_bwd_saved": 12, "linear_bwd": 12, "linear_pt": 12, "swiglu_ffn_pt": 12,
    "modnorm_residual_tangent": 24, "block_attention_tangent": 12,
    **{name: 0 for name in QUARTER_KERNELS},
}
# one sCM step at 0.25° (batch 1, 264,960 tokens): the attention on the tiled kernels (15 in
# place of 2 in the jvp primal, the first forward and the recompute; 16 and 17 in place of 6
# and 7); above the FFN's save budget the first forward and the recompute both run kernel 5
# and the backward kernel 10 (in place of 8 and 9)
QUARTER_SCM_PER_STEP = {
    **{name: 0 for name in WHOLE_GRID},
    "linear": 24, "tiled_block_attention": 36, "matmul_modnorm_residual": 24,
    "modnorm_residual": 48, "swiglu_ffn": 24, "tiled_block_attention_bwd": 12,
    "swiglu_ffn_bwd_recompute": 12, "linear_bwd": 12, "linear_pt": 12, "swiglu_ffn_pt": 12,
    "modnorm_residual_tangent": 24, "tiled_block_attention_tangent": 12,
}
SCM = ScmSlice("scm", SCM_EXPERIMENT, MODEL, RESOLUTION, TRAIN, SCM_PER_STEP, 16, 2,
               (SCM_CUT_DF_TOL, SCM_CUT_LOSS_TOL, SCM_CUT_GRAD_TOL), "CPU")
QUARTER_SCM = ScmSlice("quarter-scm", QUARTER_EXPERIMENT, QUARTER_MODEL, QUARTER_RES,
                       QUARTER_TRAIN, QUARTER_SCM_PER_STEP, 8, 1,
                       (QUARTER_CUT_DF_TOL, QUARTER_CUT_LOSS_TOL, QUARTER_CUT_GRAD_TOL), "card")


def _library_linear_pt(x, dx, w):
    stacked = torch.cat([x, dx])  # made once, outside the timing
    return lambda: torch.nn.functional.linear(stacked, w)


# One PyTorch call that computes the same function, timed as a yardstick (the
# port never calls it), as a maker of the timed call; None where no single
# call does.
LIBRARY = {
    "linear": lambda x, w: lambda: torch.nn.functional.linear(x, w),
    "linear_pt": _library_linear_pt,  # F.linear on the (2T, K) stack of x and dx
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


def _tensor(rng: np.random.Generator):
    def t(shape, scale=1.0, dtype=torch.bfloat16):
        a = (scale * rng.standard_normal(shape, dtype=np.float32))
        return torch.from_numpy(a).to("cuda", dtype)

    return t


def _inputs(rng: np.random.Generator, heads: int, d: int, B: int = 2) -> dict:
    gh, gw = GRID
    T = B * gh * gw
    inner = heads * d
    t = _tensor(rng)
    return {
        "x": t((T, DIM)),
        "w_qkv": t((3 * inner, DIM), DIM ** -0.5),
        "dy_qkv": t((T, 3 * inner)),
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
        "dy": t((T, DIM)),
        "gate": t((T, HIDDEN)),
        "up": t((T, HIDDEN)),
        # forward-mode tangents
        "dx": t((T, DIM)),
        "dqkv": t((B, gh, gw, 3 * inner)),
        "dy_mn": t((B, gh, gw, DIM), 3.0),
        "dr": t((B, gh, gw, DIM)),
        "dmsc": t((B, DIM), 0.2),
        "dmsh": t((B, DIM), 0.2),
    }


def check_kernel(name: str, args, label: str, reps: int = 20) -> dict:
    """One kernel against its plain version on the same inputs, every output
    of it; raises when one disagrees by more than TOL of max|plain|.
    Returns the record fields (error, times, bound, library time)."""
    fused, plain = KERNELS[name][:2]
    got = fused(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(gots, wants)]
    refs = [w.float().abs().max().item() for w in wants]
    ok = all(bool(torch.isfinite(g).all().item()) for g in gots) and all(
        e <= TOL * r for e, r in zip(errs, refs))
    del want, wants
    ms = time_ms(lambda: fused(*args), reps)
    plain_ms = time_ms(lambda: plain(*args), reps)
    lib = LIBRARY.get(name)
    library_ms = time_ms(lib(*args), reps) if lib else None
    bound_ms, bound_by = kernel_bound(name, args, got)
    rel = max(e / r for e, r in zip(errs, refs))
    log(f"[kernels] {name:29s} {label} max_abs_err={max(errs):.3e} (worst rel {rel:.2e} over "
        f"{len(errs)} outputs)  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
        f"{bound_ms:.4f} ms ({bound_by})" + (f"  library {library_ms:.4f} ms" if lib else ""))
    if not ok:
        raise AssertionError(f"{name} ({label}) disagrees with its plain version: errors {errs} "
                             f"against {TOL} x max|plain| {refs}")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _merge(record: dict, name: str, fields: dict, timing: bool) -> None:
    rec = record.setdefault(name, {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], fields["max_abs_err"])
    if timing:
        rec.update({k: v for k, v in fields.items() if k != "max_abs_err"})


def phase_kernels() -> dict:
    """Each kernel against its plain version, every output of it; returns
    the per-kernel record (error, times, bound, library time). The times of
    record are the shapes the kernel's main path gives it: the flagship's
    (12x88 heads, shift (8, 8)) for the 1.4° kernels, the 0.25° shapes for
    kernels 10 and 15-17, whose flagship times are kept beside them."""
    rng = np.random.default_rng(0)
    record: dict = {}
    for heads, d in GEOMETRIES:
        a = _inputs(rng, heads, d)
        win = (16, 16)
        cases = [
            ("linear", (a["x"], a["w_qkv"]), {}),
            ("linear_bwd", (a["dy_qkv"], a["x"], a["w_qkv"]), {}),
            ("linear_pt", (a["x"], a["dx"], a["w_qkv"]), {}),
            ("matmul_modnorm_residual",
             (a["attn"], a["w_o"], a["r"], a["g"], a["b"], a["msc"], a["msh"]), {}),
        ] + [
            ("block_attention", (a["qkv"], a["scale"], heads, win, s), {"shift": s})
            for s in SHIFTS
        ] + [
            ("block_attention_bwd", (a["qkv"], a["scale"], a["attn"], heads, win, s),
             {"shift": s})
            for s in SHIFTS
        ] + [
            ("block_attention_tangent", (a["qkv"], a["dqkv"], a["scale"], heads, win, s),
             {"shift": s})
            for s in SHIFTS
        ] + [  # the tiled kernels take qkv as rolled: no shift
            ("tiled_block_attention", (a["qkv"], a["scale"], heads, win), {}),
            ("tiled_block_attention_bwd", (a["qkv"], a["scale"], a["attn"], heads, win), {}),
            ("tiled_block_attention_tangent", (a["qkv"], a["dqkv"], a["scale"], heads, win), {}),
        ]
        if d == GEOMETRIES[0][1]:  # these do not depend on the head layout
            cases += [
                ("modnorm_residual", (a["y"], a["r"], a["g"], a["b"], a["msc"], a["msh"]), {}),
                ("swiglu_ffn", (a["x"], a["w1"], a["w2"]), {}),
                ("swiglu_ffn_fwd_save", (a["x"], a["w1"], a["w2"]), {}),
                ("swiglu_ffn_bwd_saved",
                 (a["x"], a["dy"], a["gate"], a["up"], a["w1"], a["w2"]), {}),
                ("swiglu_ffn_bwd_recompute", (a["x"], a["dy"], a["w1"], a["w2"]), {}),
                ("swiglu_ffn_pt", (a["x"], a["dx"], a["w1"], a["w2"]), {}),
                ("modnorm_residual_tangent",
                 (a["y"], a["dy_mn"], a["dr"], a["g"], a["b"], a["msc"], a["dmsc"], a["dmsh"]), {}),
            ]
        for name, args, tags in cases:
            fields = check_kernel(name, args, f"heads={heads:2d} d={d:3d} {tags or ''}")
            flagship = d == GEOMETRIES[0][1] and tags.get("shift", (8, 8)) == (8, 8)
            if name in QUARTER_KERNELS:
                _merge(record, name, {"max_abs_err": fields["max_abs_err"]}, False)
                if flagship:
                    record[name].update(flagship_ms=fields["ms"],
                                        flagship_plain_ms=fields["plain_ms"])
            else:
                _merge(record, name, fields, flagship)  # flagship timing of record
        del a
        torch.cuda.empty_cache()
    quarter_kernels(rng, record)
    return record


def quarter_kernels(rng: np.random.Generator, record: dict) -> None:
    """Kernels 10 and 15-17 at the 0.25° shapes (B = 1, 368x720 tokens, 8x128
    heads, the 264,960-token FFN), with the scratch of kernels 16 and 10:
    computed from the shapes, and read as the peak device memory of one call
    above its inputs and outputs."""
    t = _tensor(rng)
    gh, gw = QUARTER_GRID
    heads, d, T = 8, 128, gh * gw
    qkv = t((1, gh, gw, 3 * heads * d))
    scale = torch.exp(t((heads,), 0.3, torch.float32) + np.log(10.0))
    cases = [
        ("tiled_block_attention", (qkv, scale, heads, (16, 16))),
        ("tiled_block_attention_bwd", (qkv, scale, t((1, gh, gw, heads * d)), heads, (16, 16))),
        ("tiled_block_attention_tangent", (qkv, t(qkv.shape), scale, heads, (16, 16))),
        ("swiglu_ffn_bwd_recompute", (t((T, DIM)), t((T, DIM)),
                                      t((2 * HIDDEN, DIM), DIM ** -0.5),
                                      t((DIM, HIDDEN), HIDDEN ** -0.5))),
    ]
    scratch = {
        "tiled_block_attention_bwd": (tiled_bwd_scratch_bytes(1, gh, gw, heads, d, (16, 16)),
                                      _nbytes([qkv]), "the qkv it differentiates"),
        "swiglu_ffn_bwd_recompute": (bwd_recompute_scratch_bytes(T, DIM, HIDDEN), 1e9, "1 GB"),
    }
    for name, args in cases:
        fields = check_kernel(name, args, f"0.25° B=1 {gh}x{gw} heads={heads} d={d}", reps=5)
        _merge(record, name, fields, True)
        if name in scratch:
            computed, limit, what = scratch[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = KERNELS[name][0](*args)
            torch.cuda.synchronize()
            measured = torch.cuda.max_memory_allocated() - base - _nbytes(
                out if isinstance(out, tuple) else (out,))
            del out
            record[name]["scratch_bytes"] = computed
            log(f"[kernels] {name} scratch at 0.25°: {computed / 1e9:.4f} GB from the shapes, "
                f"{measured / 1e9:.4f} GB read as peak device memory above inputs and outputs "
                f"(limit {limit / 1e9:.2f} GB, {what})")
            if max(computed, measured) > limit:
                raise AssertionError(f"{name}: scratch {max(computed, measured)} > {limit} bytes")
    del cases, qkv
    torch.cuda.empty_cache()


def build_net(depth: int, dtype: torch.dtype, model: dict = MODEL, res=RESOLUTION):
    return factory.build_precond(PRECOND, {**model, "depth": depth}, res,
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


def reset_launches() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, (w, *_) in KERNELS.items()}


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
    reset_launches()
    ofile, wall, n_steps = rollout_to_store(args, dataset, net, os.path.join(WORK, "out"))
    launches = read_launches()
    log(f"[slice] kernel launches in the rollout: {launches}")
    missing = [name for name in FORWARD if launches[name] == 0]
    if missing:
        raise AssertionError(f"the rollout never launched {missing}")
    if any(launches[k] for k in KERNELS if k not in FORWARD):
        raise AssertionError(f"the rollout launched kernels of another path: {launches}")

    check_store(ofile, ROLLOUT, RESOLUTION, "slice")
    MB = ROLLOUT["members"] * ROLLOUT["batch"]
    log(f"[slice] {n_steps} forecast steps at members x batch = {MB} in "
        f"{wall:.3f} s: {n_steps / wall:.3f} forecast steps/s ({card})")

    # the device's share of that: one sCM step (one network forward) at MB
    step_ms = forward_ms(net, ROLLOUT, RESOLUTION)
    device_s = (n_steps // MB) * step_ms / 1e3  # one sampler call per MB forecast steps
    log(f"[slice] one sCM step at MB={MB}: {step_ms:.2f} ms (median of 5), i.e. "
        f"{MB / step_ms * 1e3:.3f} forecast steps/s on the device alone; the rollout's "
        f"device work is {device_s:.3f} s of its {wall:.3f} s ({card})")
    return launches


def check_store(ofile: str, rollout: dict, res, tag: str) -> None:
    """Every variable of a rollout's store at (ic, member, lead[, level]) +
    ``res``, finite, its forecast leads not constant."""
    store = read_store(ofile)
    n_ic, M, leads = rollout["samples"], rollout["members"], rollout["steps"] + 1
    expected = {v: (n_ic, M, leads) + res for v in SURFACE}
    expected.update({v: (n_ic, M, leads, len(LEVELS)) + res for v in LEVEL_VARS})
    if sorted(store) != sorted(expected):
        raise AssertionError(f"store holds {sorted(store)}, expected {sorted(expected)}")
    for var, a in store.items():
        if a.shape != expected[var]:
            raise AssertionError(f"store {var}: shape {a.shape}, expected {expected[var]}")
        if not np.isfinite(a).all():
            raise AssertionError(f"store {var}: non-finite values")
        if not a[:, :, 1:].std() > 0:
            raise AssertionError(f"store {var}: forecast leads are constant")
    log(f"[{tag}] store {os.path.relpath(ofile, ROOT)}: {len(store)} variables finite and "
        f"non-constant, shape (ic, member, lead) = {(n_ic, M, leads)} at {res[0]}x{res[1]}")


def forward_ms(net, rollout: dict, res) -> float:
    """Device milliseconds of one sCM step (one network forward) at members
    x batch, CUDA events, median of 5."""
    sampler = sampler_factory("scm", net, num_steps=1, sigma_min=0.02, sigma_max=200.0,
                              auxiliary=rollout["interval"] / 10.0)
    cond = torch.randn(rollout["members"] * rollout["batch"], *res,
                       len(VARIABLES) + len(FORCINGS), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        return time_ms(lambda: sampler(cond, gen), reps=5)


def train_config(experiment: str, *extra: str, cut: dict = TRAIN) -> dict:
    """An experiment's composed config (read from the YAML tree), cut to a
    few steps of a small global batch (``cut``: 4 at 1.4°, 1 at 0.25°). The
    2000-kimg lr warmup is cut to 0: six steps would run at lr ≈ 5e-8, below
    half an fp32 ulp of a parameter near 1, so the slice runs at the base lr
    that most of a run trains at."""
    steps_kimg = cut["batch"] / 1000.0
    return cfglib.compose("train", [
        f"experiment={experiment}",
        f"data.batch_size={cut['batch']}",
        f"trainer.total_kimg={cut['steps'] * steps_kimg}",
        f"trainer.kimg_per_tick={cut['steps_per_tick'] * steps_kimg}",
        "trainer.lr_rampup_kimg=0",
        "trainer.checkpoint_ticks=1000",  # so the one checkpoint is the final one
        *extra,
    ])


def check_config(cfg: dict, model: dict) -> None:
    ds_cfg = cfg["data"]["dataset"]
    if list(ds_cfg["variables"]) != VARIABLES or list(ds_cfg["forcings"]) != FORCINGS:
        raise AssertionError("the experiment's data config differs from the smoke's channels")
    if any(cfg["model"].get(k) != v for k, v in model.items() if k != "_target_"):
        raise AssertionError(f"the experiment's model {cfg['model']} is not {model}")


def build_trainer(cfg: dict, tag: str, run: str, model: dict = MODEL, res=RESOLUTION,
                  n_files: int = 16):
    """(dataset, loader, trainer, flops per step) for a composed config of
    ``model`` at ``res``: the full-width network with random weights (seed
    1) on the card, the config's loss and optimizer, synthetic batches."""
    check_config(cfg, model)
    t0 = time.perf_counter()
    dataset = SyntheticERA5(VARIABLES, FORCINGS, n_files=n_files, shape=res, seed=0)
    gb = int(cfg["data"]["batch_size"])
    loader = BatchLoader(dataset, InfiniteSampler(dataset, seed=0), gb,
                         num_workers=4)
    net = factory.build_precond(cfg["precond"], cfg["model"], res, len(VARIABLES),
                                len(VARIABLES) + len(FORCINGS))
    random_weights(net, seed=1)
    net = net.cuda().train()
    loss_fn = factory.build_loss(cfg["loss"], dataset)
    tcfg = cfg["trainer"]
    optimizer, lr_fn = factory.build_optimizer(cfg["optimizer"], tcfg, gb, net)
    # the JAX train.py's call: the dataset's grid, not the model's padded one
    flops = swin_flop_count(res, gb, model["depth"], 2 * len(VARIABLES) + len(FORCINGS),
                            DIM, HIDDEN, model["patch_size"], model["window_size"])
    trainer = Trainer(
        net, optimizer, loss_fn, global_batch_size=gb, lr_fn=lr_fn,
        total_kimg=float(tcfg["total_kimg"]), ema_halflife_kimg=float(tcfg["ema_halflife_kimg"]),
        ema_rampup_ratio=tcfg.get("ema_rampup_ratio", 0.05),
        kimg_per_tick=float(tcfg["kimg_per_tick"]), checkpoint_ticks=tcfg["checkpoint_ticks"],
        run_dir=os.path.join(WORK, run), flop_count=flops, seed=0,
    )
    log(f"[{tag}] {cfg['experiment_name']}: "
        f"{sum(p.numel() for p in net.parameters()) / 1e6:.1f} M params, global batch {gb}, "
        f"remat {net.model.remat_layers}, {type(loss_fn).__name__}, "
        f"{type(optimizer).__name__} with {len(optimizer.param_groups)} groups, lr ramp "
        f"{tcfg['lr_rampup_kimg']} kimg (set-up {time.perf_counter() - t0:.1f} s)")
    return dataset, loader, trainer, flops


def run_training(trainer, loader, flops: float, card: str, tag: str, expect,
                 note: str = "") -> dict:
    """Train through ``trainer.train`` with the launch counts reset just
    before and read just after; fails unless loss and grad norm stayed
    finite, every parameter moved and no kernel outside ``expect`` (the
    path's kernels) launched. Returns the counts."""
    net = trainer.net
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    reset_launches()
    trainer.train(loader)
    torch.cuda.synchronize()
    launches = read_launches()
    steps = trainer.updates
    log(f"[{tag}] {steps} steps; kernel launches in training: {launches}; per step: "
        + json.dumps({k: v / steps for k, v in launches.items()}))
    stray = [k for k in KERNELS if k not in expect and launches[k]]
    if stray:
        raise AssertionError(f"[{tag}] launched kernels of another path: {stray}")
    hist = trainer.history
    if not all(np.isfinite(hist["train/loss"])) or not all(np.isfinite(hist["train/grad_norm"])):
        raise AssertionError(f"non-finite loss or grad norm: {hist['train/loss']}, "
                             f"{hist['train/grad_norm']}")
    still = [n for n, p in net.named_parameters() if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"{len(still)} parameters did not move, e.g. {still[:3]}")
    # steady state: the ticks after the first (which carries the first step's set-up)
    ticks = list(zip(hist["train/iter"], hist["train/dt/tick"]))[1:]
    n_steps = ticks[-1][0] - hist["train/iter"][0]
    s_step = sum(dt for _, dt in ticks) / n_steps
    tflops = flops / s_step / 1e12
    gb = trainer.global_batch_size
    log(f"[{tag}] loss {hist['train/loss']}, grad norm {hist['train/grad_norm']}; every "
        f"parameter moved; peak device memory {hist['train/mem/device'][-1]:.2f} GiB")
    log(f"[{tag}] {s_step:.4f} s/step over steps 2-{ticks[-1][0]}, {gb / s_step:.3f} images/s, "
        f"{tflops:.2f} TFLOP/s by swin_flop_count ({flops / 1e12:.2f} TFLOP a step{note}) = "
        f"{100 * tflops / (PEAK_FLOPS / 1e12):.2f}% of 989 TFLOP/s bf16 dense ({card})")
    return launches


def phase_train(card: str):
    """The full-width TrigFlow training slice through the port's Trainer;
    returns (each kernel's launches in the training run, the config, the
    state dict after the six steps)."""
    cfg = train_config(TRAIN_EXPERIMENT)
    dataset, loader, trainer, flops = build_trainer(cfg, "train", "train")
    launches = run_training(trainer, loader, flops, card, "train", TRIGFLOW)
    missing = [name for name in TRIGFLOW if launches[name] == 0]
    if missing:
        raise AssertionError(f"training never launched {missing}")

    # the checkpoint's EMA forecasts through the generate path
    ckpt = latest_checkpoint(os.path.join(WORK, "train", "checkpoints"))
    ema = build_net(MODEL["depth"], torch.bfloat16)
    ema.load_state_dict(load_checkpoint(ckpt))
    ema = ema.cuda().eval()
    args = argparse.Namespace(**{**ROLLOUT, "steps": 1, "members": 1, "samples": 1,
                                 "batch": 1, "segment": 1})
    ofile, _, _ = rollout_to_store(args, dataset, ema, os.path.join(WORK, "ema_out"))
    store = read_store(ofile)
    if not all(np.isfinite(a).all() and a[:, :, 1:].std() > 0 for a in store.values()):
        raise AssertionError("the trained EMA's forecast is not finite or is constant")
    log(f"[train] checkpoint {os.path.basename(ckpt)}: EMA reloaded, one forecast step through "
        f"rollout_to_store, {len(store)} variables finite and non-constant")
    trained = {k: v.detach().float().cpu() for k, v in trainer.net.state_dict().items()}
    profile_step(trainer, next(iter(loader)), card)
    del trainer, ema
    torch.cuda.empty_cache()
    return launches, cfg, trained


MUON_WEIGHTS = ("to_qkv.weight", "wo.weight", "w1.weight", "w2.weight",
                "norm.modulation.weight")  # the JAX package's "muon" labels, a block's six


def phase_scm(card: str, sl: ScmSlice):
    """A full-width sCM training slice (SCMLoss, Muon + aux-Adam, EMA, remat)
    through the port's Trainer: the flagship's default experiment cut as the
    TrigFlow slice is (random weights, synthetic data, global batch 4, six
    steps, a tick every 2, lr warmup 0), or the 0.25° configuration of
    record at its batch of 1 for two steps. The experiments' 3000-kimg
    tangent warmup keeps r ≈ 0 over those steps, so one more step runs at
    r = 1 (``loss.tangent_warmup_kimg=0``), where dF_x enters the loss.
    Fails unless every kernel launched at the slice's exact per-step count.
    Returns (launches of the cut's steps, the config, the state dict after
    all of them and the r = 1 step)."""
    tag = sl.tag
    cfg = train_config(sl.experiment, cut=sl.cut)
    dataset, loader, trainer, flops = build_trainer(cfg, tag, tag, sl.model, sl.res, sl.n_files)
    opt = trainer.optimizer
    groups = {g["kind"]: {id(p) for p in g["params"]} for g in opt.param_groups}
    want = {n: "muon" if n.startswith("model.transformer.") and n.endswith(MUON_WEIGHTS)
            else "adam" for n, _ in trainer.net.named_parameters()}
    got = {n: "muon" if id(p) in groups["muon"] else "adam" if id(p) in groups["adam"] else None
           for n, p in trainer.net.named_parameters()}
    if got != want or muon_param_labels(trainer.net.named_parameters()) != want:
        raise AssertionError("the Muon/Adam groups differ from the JAX package's labels")
    log(f"[{tag}] Muon group: {len(groups['muon'])} weights (6 a block), Adam group: "
        f"{len(groups['adam'])} tensors, as the JAX labels give; tangent warmup "
        f"{cfg['loss']['tangent_warmup_kimg']} kimg, sigma_max {cfg['loss']['noise']['sigma_max']}")

    torch.cuda.reset_peak_memory_stats()
    launches = run_training(trainer, loader, flops, card, tag,
                            [k for k, n in sl.per_step.items() if n],
                            note=", the jvp forward not counted")
    steps = trainer.updates
    wrong = {k: (launches[k], n * steps) for k, n in sl.per_step.items()
             if launches[k] != n * steps}
    if wrong or sorted(sl.per_step) != sorted(KERNELS):
        raise AssertionError(f"sCM launches (got, expected) differ from the step's: {wrong}")
    log(f"[{tag}] the {len(KERNELS)} kernels launched at the step's exact counts over {steps} "
        f"steps, per step (the others never): "
        + json.dumps({k: n for k, n in sl.per_step.items() if n}))

    batch = next(iter(loader))
    trainer.loss_fn = factory.build_loss({**cfg["loss"], "tangent_warmup_kimg": 0}, dataset)
    out = {k: float(v) for k, v in trainer.step(batch).items()}
    torch.cuda.synchronize()
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"the r = 1 sCM step is not finite: {out}")
    log(f"[{tag}] one step at r = 1 (tangent_warmup_kimg=0): loss {out['loss']:.6f}, "
        f"grad norm {out['grad_norm']:.4f}; torch.cuda.max_memory_allocated over the steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    trained = {k: v.detach().float().cpu() for k, v in trainer.net.state_dict().items()}
    profile_step(trainer, batch, card, tag=tag)
    del trainer, opt
    torch.cuda.empty_cache()
    return launches, cfg, trained


def profile_step(trainer, batch: dict, card: str, top: int = 24, tag: str = "profile") -> None:
    """Where one more training step's time goes: torch.profiler's device
    time by kernel, their sum against the step's wall time (the device's
    idle share), after one warm-up step. A measurement only: where the
    profiler sees no device events it says so. The profiler's own host cost
    lengthens the wall of this step; the steady s/step of the unprofiled
    steps is the one to set the busy time against."""
    from torch.profiler import ProfilerActivity, profile

    trainer.step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device time by kernel; a user annotation (the optimizer's step range)
    # spans kernels already counted, so it is left out of the sum
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(ms for _, ms, _ in rows)
    if not rows:
        log(f"[{tag}] the profiler saw no device time: breakdown not measured")
        return
    log(f"[{tag}] one training step under torch.profiler: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy:.1f} ms, idle share {100 * (1 - busy / (wall * 1e3)):.1f}% ({card})")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"[{tag}] {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:4d}  {name[:110]}")


def cut_inputs(trained: dict, res=RESOLUTION, batch: int = 2):
    """(depth-2 state dict of ``trained``, dataset, x, condition, auxiliary):
    the first two blocks of a trained net and a batch of real-sized
    synthetic samples."""
    sd = {k: v for k, v in trained.items()
          if ".layers." not in k or int(k.split(".layers.")[1].split(".")[0]) < 2}
    dataset = SyntheticERA5(VARIABLES, FORCINGS, n_files=8, shape=res, seed=3)
    samples = [dataset[(i, 1, 6)] for i in range(batch)]
    cond = torch.from_numpy(np.stack([s[0][0] for s in samples]))
    x = torch.from_numpy(np.stack([s[0][1] for s in samples]))
    aux = torch.from_numpy(np.stack([[s[1][1]] for s in samples]))
    return sd, dataset, x, cond, aux


def compare_cut(tag: str, out: dict, loss_tol: float, grad_tol: float, batch: int = 2,
                plain_on: str = "CPU") -> dict:
    """Loss and every gradient of ``out["cuda"]`` (bf16 kernels) against
    ``out["cpu"]`` (fp32 plain), each ``(loss, {name: grad})``."""
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    rels = {n: ((gg[n] - gc[n]).norm() / gc[n].norm()).item() for n in gc}
    worst = max(rels, key=rels.get)
    log(f"[{tag}] depth-2, batch {batch}, fixed draws: loss {lg:.6f} (kernels, bf16) vs {lc:.6f} "
        f"(plain, fp32, {plain_on}), rel {loss_rel:.3e} (limit {loss_tol}); worst gradient "
        f"{worst}: rel L2 {rels[worst]:.3e} (limit {grad_tol}) over {len(rels)} tensors; "
        f"median {float(np.median(list(rels.values()))):.3e}")
    if not np.isfinite(lg) or loss_rel > loss_tol:
        raise AssertionError(f"{tag}: depth-2 cut loss disagrees: {lg} vs {lc}")
    bad = {n: r for n, r in rels.items() if not r <= grad_tol}
    if bad:
        raise AssertionError(f"{tag}: depth-2 cut gradients disagree: {bad}")
    return {"loss_rel": loss_rel, "worst": worst, "worst_rel": rels[worst]}


def phase_grad_cut(cfg: dict, trained: dict) -> dict:
    """A depth-2 cut of the trained net (same widths, its weights after the
    six steps), one batch of 2 with fixed draws: loss and every parameter's
    gradient through the kernels in bf16 on the card against the plain path
    in fp32 on the CPU."""
    sd, dataset, x, cond, aux = cut_inputs(trained)
    loss_fn = factory.build_loss(cfg["loss"], dataset)
    t, z = loss_fn.draw(x, torch.Generator().manual_seed(4))
    out = {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        cut = build_net(2, dtype)
        cut.load_state_dict(sd)
        cut = cut.to(dev).train()
        loss = loss_fn.value(cut, x.to(dev), t.to(dev), z.to(dev), cond.to(dev), aux.to(dev))
        loss.backward()
        out[dev] = (loss.item(), {n: p.grad.detach().float().cpu()
                                  for n, p in cut.named_parameters()})
    return compare_cut("cut", out, CUT_LOSS_TOL, CUT_GRAD_TOL)


def phase_scm_cut(cfg: dict, trained: dict, sl: ScmSlice) -> dict:
    """A depth-2 cut of the sCM-trained net, one batch with fixed draws: its
    tangent dF_x (the jvp forward, through the tangent kernels on the card)
    and then the sCM loss at r = 1 and every gradient, in bf16 on the card
    against the plain path in fp32 (on the CPU, or on the card for a cut
    the CPU cannot run in time). A tangent dropped on the way is finite but
    wrong: this is the check that sees it."""
    tag = f"{sl.tag}-cut"
    df_tol, loss_tol, grad_tol = sl.cut_tols
    sd, dataset, x, cond, aux = cut_inputs(trained, sl.res, sl.cut_batch)
    loss_fn = factory.build_loss({**cfg["loss"], "tangent_warmup_kimg": 0}, dataset)  # r = 1
    t, z = loss_fn.draw(x, torch.Generator().manual_seed(4))
    plain = ("cuda", plain_on_card) if sl.plain_on == "card" else ("cpu", contextlib.nullcontext)
    out, dF = {}, {}
    for key, dtype, (dev, mode) in (("cuda", torch.bfloat16, ("cuda", contextlib.nullcontext)),
                                    ("cpu", torch.float32, plain)):
        cut = build_net(2, dtype, sl.model, sl.res)
        cut.load_state_dict(sd)
        cut = cut.to(dev).train()
        xd, td, zd = x.to(dev), t.to(dev), z.to(dev)
        with mode():
            dfx = loss_fn.jvp_term(cut, td, *loss_fn.interpolate(xd, td, zd), cond.to(dev),
                                   aux.to(dev))
            loss = loss_fn.value(cut, xd, td, zd, 0.0, cond.to(dev), aux.to(dev), dF_x=dfx)
            loss.backward()
        dF[key] = dfx.float().cpu()
        out[key] = (loss.item(), {n: p.grad.detach().float().cpu()
                                  for n, p in cut.named_parameters()})
        del cut, loss, dfx
        torch.cuda.empty_cache()
    dg, dc = dF["cuda"], dF["cpu"]
    df_rel = ((dg - dc).norm() / dc.norm()).item()
    log(f"[{tag}] depth-2 tangent dF_x at {sl.res}, kernels bf16 vs plain fp32 "
        f"({sl.plain_on}): rel L2 {df_rel:.3e} (limit {df_tol}), max|dF| "
        f"{dc.abs().max().item():.4f}")
    if not torch.isfinite(dg).all() or df_rel > df_tol:
        raise AssertionError(f"depth-2 sCM tangent disagrees: rel L2 {df_rel}")
    return {"df_rel": df_rel, **compare_cut(tag, out, loss_tol, grad_tol, sl.cut_batch,
                                            sl.plain_on)}


def phase_quarter_forecast(card: str) -> dict:
    """The 0.25° configuration of record's forecast through
    ``rollout_to_store`` at full width, random weights; returns each
    kernel's launch count in that run."""
    t0 = time.perf_counter()
    net = build_net(QUARTER_MODEL["depth"], torch.bfloat16, QUARTER_MODEL, QUARTER_RES)
    random_weights(net)
    model = net.model
    (ph, _), (wh, _) = QUARTER_MODEL["patch_size"], QUARTER_MODEL["window_size"]
    lat_pad = -QUARTER_RES[0] % (ph * wh)  # 15 edge rows: 721 -> 736
    if (model.grid_size, model.lat_pad) != (QUARTER_GRID, lat_pad):
        raise AssertionError(f"0.25° grid {model.grid_size}, lat pad {model.lat_pad}")
    dataset = SyntheticERA5(VARIABLES, FORCINGS, n_files=4, shape=QUARTER_RES, seed=0)
    net = net.cuda().eval()
    log(f"[quarter] {QUARTER_EXPERIMENT}: {sum(p.numel() for p in net.parameters()) / 1e6:.1f} M "
        f"params, grid {QUARTER_RES} padded to {QUARTER_RES[0] + lat_pad} rows, tokens "
        f"{model.grid_size} (set-up {time.perf_counter() - t0:.1f} s)")
    args = argparse.Namespace(**QUARTER_ROLLOUT)
    reset_launches()
    ofile, wall, n_steps = rollout_to_store(args, dataset, net, os.path.join(WORK, "quarter_out"))
    launches = read_launches()
    log(f"[quarter] kernel launches in the rollout: {launches}")
    forwards = n_steps // (QUARTER_ROLLOUT["members"] * QUARTER_ROLLOUT["batch"])
    want = {"linear": 12, "tiled_block_attention": 12, "matmul_modnorm_residual": 12,
            "modnorm_residual": 12, "swiglu_ffn": 12}
    wrong = {k: (n, want.get(k, 0) * forwards) for k, n in launches.items()
             if n != want.get(k, 0) * forwards}
    if wrong:
        raise AssertionError(f"0.25° forecast launches (got, expected) over {forwards} forwards: "
                             f"{wrong}")
    check_store(ofile, QUARTER_ROLLOUT, QUARTER_RES, "quarter")
    log(f"[quarter] kernel 15 launched 12 times a forward over {forwards} forwards, kernel 2 "
        f"never; {n_steps} forecast steps in {wall:.3f} s end to end ({card})")
    step_ms = forward_ms(net, QUARTER_ROLLOUT, QUARTER_RES)
    log(f"[quarter] one sCM step (one network forward) at 1 member x 1 IC: {step_ms:.2f} ms on "
        f"the device (median of 5, CUDA events) ({card})")
    del net
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def plain_on_card():
    """Every kernel wrapper takes its plain PyTorch version for CUDA tensors
    too, as it does for CPU tensors: the reference run of a cut the CPU
    cannot run in time. A switch of this script's comparison only; no path
    of the port takes it."""
    on_cpu = _build.on_cpu
    _build.on_cpu = lambda *tensors: True
    try:
        yield
    finally:
        _build.on_cpu = on_cpu


def main() -> int:
    card = phase_environment()
    phase_build()
    record = phase_kernels()
    try:
        forecast = phase_slice(card)
        trigflow, cfg, trained = phase_train(card)
        phase_grad_cut(cfg, trained)
        launches, cfg, trained = phase_scm(card, SCM)
        phase_scm_cut(cfg, trained, SCM)
        del trained
        quarter_forecast = phase_quarter_forecast(card)
        quarter, cfg, trained = phase_scm(card, QUARTER_SCM)
        phase_scm_cut(cfg, trained, QUARTER_SCM)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"[train] launches: forecast {forecast}, TrigFlow training {trigflow}, "
        f"sCM training {launches}, 0.25° forecast {quarter_forecast}, 0.25° sCM training "
        f"{quarter}")
    # each kernel's launches on its main path: the 1.4° sCM step, or the 0.25° one
    launches = {k: quarter[k] if k in QUARTER_KERNELS else n for k, n in launches.items()}
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in
                         ("jax", "jaxlib", "flax", "optax", "swift_tpu"))
    if jax_modules:
        raise AssertionError(f"the port loaded JAX-package modules: {jax_modules[:5]}")
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
