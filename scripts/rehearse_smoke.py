"""Rehearse ``chip_smoke.py``'s 0.25° phases, its sCM slices, its int8
forecast and scoring phases, its solver, online-validation and EDM phases
with their cuts, its fine-tune and distill phases with their cuts, and its
per-head phases (kernel 20's entry,
``synthetic-tiny-scm`` through training and ``generate.main``, bf16 and
``--int8``, the 8x8-window forecast, sCM steps and cuts, the d = 160
forward), its data-parallel phase (two gloo ranks of this script,
``--dp-rank``, and one process) and its tensor-parallel phase (two gloo
ranks, ``--tp-rank``, data 1 x model 2, and one process) on the CPU; its
pipeline-parallel phase (two gloo ranks, ``--pp-rank``, data 1 x pipe 2,
and one process) alone with ``--pp``.

    python scripts/rehearse_smoke.py
    python scripts/rehearse_smoke.py --tp [world]   # the tensor-parallel phase alone
    python scripts/rehearse_smoke.py --tp-spread    # its tiny run's spread, six seeds
    python scripts/rehearse_smoke.py --pp [world]   # the pipeline-parallel phase alone

The kernels run only on a GPU, so this drives the smoke's own phase
functions with every wrapper on its plain PyTorch version at a tiny width
(dim 32, 2 heads of 16, depth 2) and a tiny latitude-padded grid (30x64 at
0.25°, 16x32 at 1.4°): ``.cuda()`` and ``torch.cuda.*`` are stubbed, the
timer returns 1 ms, and the launch counts read back what each phase
expects. It finds wrong paths, shapes and control flow before a chip call.
The int8 phases (the flagship's bf16 forecast, its int8 forecast at two
head layouts, the scoring of both stores, the 0.25° int8 forward) and the
solver, validation and EDM phases read real counts instead: every forward
kernel wrapper the model calls adds one to its count as it would on the
card (the backward kernels count nothing here, so the EDM phase is held to
the forward kernels only).
The per-head phases read the launch counts each phase states (the
rehearsal hands them back), at width 32 (the tiny experiment at its own
width) on 16x32- and 32x64-pixel grids.
The cuts compare the plain path in bf16 against fp32, so their errors are
the bf16 rounding of the plain path at width 32, not the kernels'; their
limits are opened to 0.5 here. No number it prints is a device number.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

TINY = {"dim": 32, "heads": 2, "head_dim": 16, "depth": 2, "window_size": [4, 8],
        "shift_size": [2, 4]}
OPEN = (0.5, 0.5, 0.5)


def stub_the_card() -> None:
    torch.Tensor.cuda = lambda self, *a, **k: self
    torch.nn.Module.cuda = lambda self, *a, **k: self
    to, module_to = torch.Tensor.to, torch.nn.Module.to

    def tensor_to(self, *a, **k):
        a = tuple(x for x in a if not (isinstance(x, str) and x.startswith("cuda")))
        if str(k.get("device", "")).startswith("cuda"):
            k.pop("device")
        return to(self, *a, **k)

    torch.Tensor.to = tensor_to
    torch.nn.Module.to = lambda self, *a, **k: self if a[:1] == ("cuda",) else module_to(
        self, *a, **k)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    randn = torch.randn
    torch.randn = lambda *a, device=None, **k: randn(*a, **k)
    cs.time_ms = lambda fn, reps=20: (fn(), 1.0)[1]
    cs.queued_ms = cs.time_ms
    cs.profile_step = lambda *a, **k: print("[rehearsal] profile step skipped")
    cs.profile_forward = lambda *a, **k: print("[rehearsal] profile forward skipped")


def count_calls() -> None:
    """Each kernel wrapper the model calls adds one to its launch count, as
    its kernel launch does on the card (on the CPU the wrappers count
    nothing)."""
    import swift_torch.models.swinv2 as sw

    for name in ("fused_block_attention", "fused_tiled_block_attention", "fused_linear",
                 "fused_matmul_modnorm_residual", "fused_matmul_modnorm_residual_int8",
                 "fused_modnorm_residual", "fused_swiglu_ffn", "fused_swiglu_ffn_int8",
                 "per_head_window_attention"):
        fn = getattr(sw, name)
        # the per-head route launches kernel 21 once a forward
        counter = cs.window_attention if name == "per_head_window_attention" else fn

        def counted(*a, _fn=fn, _counter=counter, **k):
            _counter.launches += 1
            return _fn(*a, **k)

        setattr(sw, name, counted)


def rehearse_int8(read_launches) -> None:
    """The flagship forecast, the int8 forecast at both head layouts, the
    scoring of the bf16 and int8 stores, and the 0.25° int8 forward, at
    width 32 with every block on its real route."""
    cs.read_launches = read_launches
    count_calls()
    # 256-token windows (what the whole-grid kernels take) on a 16x32-token grid
    cs.RESOLUTION = (32, 64)
    cs.MODEL = {**cs.MODEL, **TINY, "window_size": [16, 16], "shift_size": [8, 0]}  # whole-grid
    cs.HD128_MODEL = {**cs.MODEL, "heads": 4, "head_dim": 8}
    depth = TINY["depth"]
    cs.INT8_FORWARD = {k: depth for k in cs.INT8_FORWARD}
    # the tiny 0.25° grid's (4, 8) windows take the per-head route for both blocks
    cs.QUARTER_INT8_FORWARD = {**{k: depth for k in cs.QUARTER_INT8_FORWARD
                                  if k != "tiled_block_attention"}, "window_attention": depth}
    evaluate = cs.metrics.evaluate
    cs.metrics.evaluate = lambda truth, pred, device: evaluate(truth, pred, "cpu")
    generator = torch.Generator
    torch.Generator = lambda device=None: generator()
    try:
        cs.phase_slice("CPU rehearsal")
        _, store = cs.phase_int8("CPU rehearsal", cs.MODEL, "int8")
        cs.phase_int8("CPU rehearsal", cs.HD128_MODEL, "int8-hd128")
        cs.phase_scoring(os.path.join(cs.WORK, "out", os.path.basename(store)), store)
        cs.phase_quarter_int8("CPU rehearsal")
        rehearse_solvers_val_edm()
    finally:
        torch.Generator = generator


def rehearse_solvers_val_edm() -> None:
    """The solver phase (dpm-20, 2s-8), online validation inside TrigFlow
    training, the EDM phase and the EDM and sampler cuts, at width 32 with
    whole-grid 16x16 windows on a 16x32-token grid; the cuts' limits
    opened."""
    whole = {**TINY, "window_size": [16, 16], "shift_size": [8, 0]}
    base = cs.train_config
    cs.train_config = lambda exp, *extra, cut=cs.TRAIN: base(
        exp, *(f"model.{k}={v}".replace(" ", "") for k, v in whole.items()), *extra, cut=cut)
    cs.EDM_MODEL = {**cs.MODEL, "logvar": False}
    cs.TRIGFLOW = cs.FORWARD
    cs.SOLVER_CUT_TOL = cs.CUT_LOSS_TOL = cs.CUT_GRAD_TOL = 0.5
    cs.generate.resolve_device = lambda name: torch.device("cpu")
    try:
        dpm_cfg, dpm_weights = cs.phase_solvers("CPU rehearsal")
        cs.phase_val("CPU rehearsal")
        edm_cfg, edm_trained = cs.phase_edm("CPU rehearsal")
        cs.phase_edm_cuts(edm_cfg, edm_trained, dpm_cfg, dpm_weights)
        rehearse_finetune_distill()
    finally:
        cs.train_config = base


def rehearse_finetune_distill() -> None:
    """The TrigFlow slice (its run is what the next two resume and distil),
    the fine-tune through ``train.resume_setup`` with MARS after it, the
    distillation through ``train.distill_setup``, and both cuts, at width
    32. The forward wrappers count their calls here, so the fine-tune's
    steps are held to the calls its launch counts imply: every forward of a
    block calls each of the five wrappers once where kernel 1 launches once
    (the first forward, the recompute, a checkpointed step's recompute),
    which checks the checkpoint and remat structure the counts assume. The
    distillation's steps read back ``DISTILL_PER_STEP`` (control flow only)."""
    depth = TINY["depth"]
    finetune_step = cs.finetune_step

    def forward_calls(unroll, members=cs.FINETUNE["members"]):
        n = finetune_step(unroll, members)["linear"] * depth // 12
        return {k: n if k in cs.FORWARD else 0 for k in cs.KERNELS}

    read_launches, counted = cs.read_launches, {"steps": 0}

    def distill_launches():  # cumulative: DISTILL_PER_STEP more after each step
        counted["steps"] += 1
        return {k: n * (counted["steps"] // 2) for k, n in cs.DISTILL_PER_STEP.items()}

    cs.finetune_step = forward_calls
    cs.FINETUNE_CUT_TOLS = cs.DISTILL_CUT_TOLS = (0.5, 0.5, 0.5)
    try:
        _, cfg, trained = cs.phase_train("CPU rehearsal")
        ft_cfg = cs.phase_finetune("CPU rehearsal", cfg)
        print(cs.phase_finetune_cut(ft_cfg, trained))
        cs.read_launches = distill_launches
        distill_cfg, distilled, teacher_sd = cs.phase_distill("CPU rehearsal")
        print(cs.phase_distill_cut(distill_cfg, distilled, teacher_sd))
    finally:
        cs.finetune_step, cs.read_launches = finetune_step, read_launches


def rehearse_per_head(queue: list) -> None:
    """Kernel 20's entry, path A (the tiny experiment as shipped, through
    ``generate.main`` on the CPU), path B at width 32 on a 16x32-token grid
    with 8x8 windows, path C at d = 160 on 16x16 windows. ``queue`` takes
    the launch counts each read of the phases states, in order."""
    base = {k: 0 for k in cs.KERNELS}
    counts = lambda want, times: {**base, **{k: n * times for k, n in want.items()}}  # noqa
    cs.generate.resolve_device = lambda name: torch.device("cpu")
    generator = torch.Generator
    torch.Generator = lambda device=None: generator()
    try:
        queue[:] = [counts({"swiglu_ffn_modnorm": 1}, 1)]
        cs.phase_ffn_modnorm("CPU rehearsal")

        tiny = cs.per_head_step(2)
        cs.TINY_CUT = dataclasses.replace(cs.TINY_CUT, cut_tols=OPEN)
        queue[:] = [counts(tiny, cs.TINY_TRAIN["steps"]), counts(cs.PER_HEAD_FORWARD, 4),
                    counts(cs.PER_HEAD_FORWARD, 4), counts(cs.PER_HEAD_INT8_FORWARD, 4)]
        cs.phase_tiny("CPU rehearsal")

        cs.RESOLUTION = (32, 64)
        cs.WIN8_MODEL = {**cs.MODEL, **TINY, "window_size": [8, 8], "shift_size": [4, 4]}
        queue[:] = [counts(cs.PER_HEAD_FORWARD, 2 * TINY["depth"])]
        cs.phase_win8_forecast("CPU rehearsal")
        sl = dataclasses.replace(cs.WIN8_SCM, model=cs.WIN8_MODEL, res=cs.RESOLUTION,
                                 cut_tols=OPEN, n_files=8, per_step=cs.per_head_step(2),
                                 overrides=cs.WIN8_OVERRIDES)
        queue[:] = [counts(sl.per_step, sl.cut["steps"])]
        _, cfg, trained = cs.phase_scm("CPU rehearsal", sl)
        print(cs.phase_scm_cut(cfg, trained, sl))

        cs.D160_MODEL = {**cs.MODEL, **TINY, "heads": 2, "head_dim": 160,
                         "window_size": [16, 16], "shift_size": [8, 8]}
        queue[:] = [counts(cs.PER_HEAD_FORWARD, TINY["depth"])]
        cs.phase_d160("CPU rehearsal")
    finally:
        torch.Generator = generator


def dp_at_width_32() -> None:
    """The data-parallel phase at width 32 on a 16x32 grid on the CPU, in
    the phase's process and in its ranks (this script with ``--dp-rank``);
    the launch counts read back the sCM step's."""
    cs.RESOLUTION = (16, 32)
    argv = cs.dp_argv
    cs.dp_argv = lambda: [a if a != "cuda" else "cpu" for a in argv()] + [
        f"model.{k}={v}".replace(" ", "") for k, v in TINY.items()]
    cs.DP_ROLLOUT = {**cs.DP_ROLLOUT, "device": "cpu"}
    cs.DP_WORKER = [sys.executable, os.path.abspath(__file__), "--dp-rank"]
    cs.phase_environment = lambda: "CPU rehearsal"
    cs.reset_launches = lambda: None
    cs.read_launches = lambda: {k: n * cs.DP["steps"]
                                for k, n in cs.at_depth(cs.SCM_PER_STEP, cs.DP["depth"]).items()}
    torch.cuda.current_device = lambda: 0


# the tensor-parallel runs at width 48 on 16x16 windows, the whole-grid route (6 heads of 8: 3 a
# rank; SwiGLU 128: 64 a rank), the 8 x 128 run at 2 heads of 16 (1 a rank), the tiny
# experiment at its own width
TP_FLAGSHIP = {"dim": 48, "heads": 6, "head_dim": 8, "window_size": [16, 16],
               "shift_size": [8, 8]}
TP_HD128 = {**TP_FLAGSHIP, "dim": 32, "heads": 2, "head_dim": 16}
TP_TINY = cs.TP_RUNS[2]  # synthetic-tiny-scm at its own width


def tp_at_width_48() -> None:
    """The tensor-parallel phase on a 32x64 grid on the CPU, in the phase's
    process and in its ranks (this script with ``--tp-rank``); the launch
    counts read back each run's expected ones."""
    cs.RESOLUTION = (32, 64)
    cs.DIM, cs.HIDDEN = 48, 128

    def overrides(model: dict) -> tuple:
        return tuple(f"model.{k}={v}".replace(" ", "") for k, v in model.items())

    cs.TP_RUNS = (
        cs.TpRun("flagship", cs.SCM_EXPERIMENT, (*overrides(TP_FLAGSHIP), "model.depth=2"),
                 "flagship", 2, 2, 3),
        cs.TpRun("hd128", cs.SCM_EXPERIMENT, (*overrides(TP_HD128), "model.depth=2"),
                 "flagship", 2, 1, 1),
        TP_TINY,
    )
    current = {}
    argv = cs.tp_argv

    def cpu_argv(run, system=True):
        current["run"] = run
        return [a if a != "cuda" else "cpu" for a in argv(run, system)]

    cs.tp_argv = cpu_argv
    cs.TP_ROLLOUT = {**cs.TP_ROLLOUT, "device": "cpu"}
    cs.TP_WORKER = [sys.executable, os.path.abspath(__file__), "--tp-rank"]
    cs.phase_environment = lambda: "CPU rehearsal"
    cs.reset_launches = lambda: None
    on_cpu = cs._build.on_cpu

    def kernel_ready(*tensors):
        """The CUDA wrappers' alignment check on what would go to a kernel,
        before its plain version runs: a contiguous input off a 16-byte
        boundary stays there through ``.contiguous()``, and the kernel's
        wrapper refuses it (a sliced view, say)."""
        for t in tensors:
            if t.is_contiguous() and t.data_ptr() % 16:
                raise AssertionError(f"a kernel input {tuple(t.shape)} is not 16-byte aligned")
        return on_cpu(*tensors)

    cs._build.on_cpu = kernel_ready
    cs.read_launches = lambda: {k: n * current["run"].steps
                                for k, n in cs.tp_expected(current["run"]).items()}
    torch.cuda.current_device = lambda: 0
    if os.environ.get("REHEARSE_TP_SEED"):  # --tp-spread: the tiny run alone at that seed
        cs.TP_RUNS = (dataclasses.replace(TP_TINY, overrides=(
            f"seed={os.environ['REHEARSE_TP_SEED']}",)),)


def tp_spread(seeds=range(6)) -> None:
    """The tensor-parallel phase's ``synthetic-tiny-scm`` run at ``seeds``
    on the CPU: its loss (over ``chip_smoke.loss_scale``) and gradient norm
    on two gloo ranks against one process, and a bf16 control, one process
    against itself with each attention block's wo product rounded to bf16
    before the epilogue (the form a tensor-parallel rank takes, with no
    collective: one bf16 rounding of y more a block). Prints each seed's
    relative differences and the largest."""
    import swift_torch.models.swinv2 as swinv2

    rows = []
    for k in seeds:
        os.environ["REHEARSE_TP_SEED"] = str(k)
        tp_at_width_48()
        run = cs.TP_RUNS[0]
        work = os.path.join(cs.WORK, "tp")  # where the ranks write
        shutil.rmtree(work, ignore_errors=True)
        for sub_dir in ("ranks", "one", "control/one"):
            os.makedirs(os.path.join(work, sub_dir))
        ranks = cs.run_ranks(work, cs.TP, cs.TP_WORKER, "tp", f"tp-spread{k}")
        one = cs.tp_reference(run, ranks, work)
        setup, identity = cs.train_lib.setup, (lambda x, group: x)

        def unfused(*args, **kwargs):
            trainer, loader, rest = setup(*args, **kwargs)
            for m in trainer.net.modules():
                if isinstance(m, swinv2.WindowAttention):
                    m.split = True  # with one rank: wo plain in bf16, then the epilogue
            return trainer, loader, rest

        cs.train_lib.setup = unfused
        swinv2.copy_to_model = swinv2.reduce_from_model = identity
        control = cs.tp_reference(run, ranks, os.path.join(work, "control"))
        cs.train_lib.setup = setup
        r0 = ranks[0]["runs"][run.tag]
        row = {"seed": k}
        for name, got in (("tp", r0), ("control", control)):
            row[f"{name}_loss"] = max(abs(a - b) / s for a, b, s in zip(
                got["losses"], one["losses"], one["scales"]))
            row[f"{name}_gnorm"] = max(abs(a - b) / abs(b) for a, b in zip(
                got["grad_norms"], one["grad_norms"]))
        row.update(loss=one["losses"], scale=one["scales"])
        print(f"[tp-spread] {row}", flush=True)
        rows.append(row)
    for key in ("tp_loss", "tp_gnorm", "control_loss", "control_gnorm"):
        print(f"[tp-spread] largest {key} over seeds {list(seeds)}: "
              f"{max(r[key] for r in rows):.3e}")


def pp_at_width_48() -> None:
    """The pipeline-parallel phase at width 48 (6 heads of 8 on 16x16
    windows, the whole-grid route) on a 32x64 grid on the CPU, in the
    phase's process and in its ranks (this script with ``--pp-rank``): the
    forward wrappers count their calls, the phase's exact launch counts are
    not read (the kernels count nothing on the CPU)."""
    import swift_torch.utils.device as device

    cs.RESOLUTION = (32, 64)
    cs.MODEL = {**cs.MODEL, **TP_FLAGSHIP}
    cs.PP_ROLLOUT = {**cs.PP_ROLLOUT, "device": "cpu"}
    cs.PP_WORKER = [sys.executable, os.path.abspath(__file__), "--pp-rank"]
    cs.phase_environment = lambda: "CPU rehearsal"
    cs._exact = lambda launches, want, times, tag: print(f"[rehearsal] {tag}: exact launches "
                                                          "not read on the CPU")
    cs.generate.resolve_device = device.resolve_device = lambda name: torch.device("cpu")
    main, generator = cs.generate.main, torch.Generator

    def main_on_cpu(*args, **kwargs):  # the engine's generators on the CPU
        torch.Generator = lambda device=None: generator()
        try:
            return main(*args, **kwargs)
        finally:
            torch.Generator = generator

    cs.generate.main = main_on_cpu
    count_calls()


def main() -> None:
    read_launches = cs.read_launches
    stub_the_card()
    cs.QUARTER_RES, cs.QUARTER_GRID = (30, 64), (16, 32)
    cs.QUARTER_MODEL = {**cs.QUARTER_MODEL, **TINY}
    cs.DIM, cs.HIDDEN = 32, 40
    compose = cs.train_config
    cs.train_config = lambda exp, *extra, cut=cs.TRAIN: compose(
        exp, *(f"model.{k}={v}".replace(" ", "") for k, v in TINY.items()), *extra, cut=cut)
    expected: dict = {}
    cs.read_launches = lambda: dict(expected)
    kernels = list(cs.KERNELS)

    cs.quarter_kernels(np.random.default_rng(0), {})

    expected.update({k: 0 for k in kernels})
    expected.update({k: 12 * cs.QUARTER_ROLLOUT["steps"]  # 12 a forward, one a step
                     for k in ("linear", "tiled_block_attention", "matmul_modnorm_residual",
                               "modnorm_residual", "swiglu_ffn")})
    generator = torch.Generator
    torch.Generator = lambda device=None: generator()
    cs.phase_quarter_forecast("CPU rehearsal")
    torch.Generator = generator

    for sl in (
        dataclasses.replace(cs.QUARTER_SCM, model=cs.QUARTER_MODEL, res=cs.QUARTER_RES,
                            cut_tols=OPEN),
        dataclasses.replace(cs.SCM, model={**cs.MODEL, **TINY}, res=(16, 32), cut_tols=OPEN,
                            n_files=8, cut={"batch": 2, "steps": 2, "steps_per_tick": 1}),
    ):
        expected.update({k: sl.cut["steps"] * sl.per_step.get(k, 0) for k in kernels})
        _, cfg, trained = cs.phase_scm("CPU rehearsal", sl)
        print(cs.phase_scm_cut(cfg, trained, sl))

    rehearse_int8(read_launches)

    queue: list = []
    cs.read_launches = lambda: dict(queue.pop(0))
    cs.WINDOW_SHAPES = ((8, 2, 64, 16), (4, 2, 256, 160), (2, 2, 1024, 8))
    cs.WINDOW_EXTRA_SHAPES = ((4, 2, 36, 16), (2, 2, 257, 8))
    cs.FFN_MN_TOKENS = 512
    cs.window_kernels(np.random.default_rng(0), {})
    rehearse_per_head(queue)

    dp_at_width_32()
    cs.phase_dp("CPU rehearsal")
    tp_at_width_48()
    cs.phase_tp("CPU rehearsal")


if __name__ == "__main__":
    if sys.argv[1:] == ["--dp-rank"]:
        stub_the_card()
        dp_at_width_32()
        sys.exit(cs.dp_worker())
    if sys.argv[1:] == ["--tp-rank"]:
        stub_the_card()
        tp_at_width_48()
        sys.exit(cs.tp_worker())
    if sys.argv[1:] == ["--pp-rank"]:
        stub_the_card()
        pp_at_width_48()
        sys.exit(cs.pp_worker())
    if sys.argv[1:2] == ["--pp"]:  # the pipeline-parallel phase alone, [world] ranks
        stub_the_card()
        pp_at_width_48()
        if sys.argv[2:]:  # data world/2 x pipe 2
            cs.PP["world"] = int(sys.argv[2])
        try:
            sys.exit(cs.phase_pp("CPU rehearsal") and 0)
        finally:
            shutil.rmtree(cs.WORK, ignore_errors=True)
    if sys.argv[1:] == ["--tp-spread"]:  # the tiny TP run's spread over six seeds
        stub_the_card()
        try:
            sys.exit(tp_spread())
        finally:
            shutil.rmtree(cs.WORK, ignore_errors=True)
    if sys.argv[1:2] == ["--tp"]:  # the tensor-parallel phase alone, [world] ranks
        stub_the_card()
        tp_at_width_48()
        cs.TP["world"] = int(sys.argv[2]) if sys.argv[2:] else cs.TP["world"]
        try:
            sys.exit(cs.phase_tp("CPU rehearsal") and 0)
        finally:
            shutil.rmtree(cs.WORK, ignore_errors=True)
    try:
        main()
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
