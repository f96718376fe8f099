"""Time kernels 4 and 12 (the post-FFN modnorm and its tangent) of one
checkout of the repo on the card, and the plain backward of the modnorm
epilogues.

    python scripts/ab_modnorm.py [--root DIR]

For the checkout at ``--root`` (default: this one): kernels 4 and 12
through their wrappers at the flagship's B = 2 (64x128 tokens a sample, D =
1056) and at the 0.25° shape (B = 1, 368x720 tokens), single calls (CUDA
events, median) and queued back to back, beside their bound and their plain
versions, with the host's own time a call; then kernel 4's launches in
one full-width flagship forward at members x batch = 4 under
torch.profiler (the device time of its kernel by name, against the
forward's busy time); then the plain vjp that is the
backward of kernels 4's and 3's epilogues (``_Modnorm.backward``,
``_MatmulModnorm.backward``, run by ``torch.autograd.grad`` on the
Function's output) at the flagship's B = 4, single and queued.

An earlier commit unpacked with ``git archive <commit> | tar -x -C DIR``
runs through the same steps, so that two checkouts compare in one call on
one card: run this on each in turns (the earlier, this, this, the earlier).
Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path


def host_us(fn, calls: int = 100) -> float:
    """Microseconds of the host's own time a call: ``calls`` calls queued
    without a wait, on the host's clock (the device runs behind them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def kernel_rows(name: str, fused, args, label: str, reps: int, cs) -> None:
    fields = cs.check_kernel(name, args, label, reps=reps)
    queued = cs.queued_ms(lambda: fused(*args), reps)
    bound = fields["bound_ms"]
    cs.log(f"[ab-modnorm] {name} at {label}: {fields['ms']:.4f} ms single "
           f"({100 * bound / fields['ms']:.1f}% of its bound), {queued:.4f} ms queued "
           f"({100 * bound / queued:.1f}%), bound {bound:.4f} ms, plain "
           f"{fields['plain_ms']:.4f} ms; the host's own time a call "
           f"{host_us(lambda: fused(*args)):.1f} us")


def forward_profile(cs, card: str) -> None:
    """Kernel 4's device time in one flagship forward at MB = 4: the rows of
    torch.profiler's table whose kernel is kernel 4 (``modnorm_rows_kernel
    <false>``, or ``kernel``, the Triton function's name in earlier
    checkouts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    net = cs.build_net(cs.MODEL["depth"], torch.bfloat16)
    cs.random_weights(net)
    net = net.cuda().eval()
    call = cs._forward_call(net, cs.ROLLOUT, cs.RESOLUTION)
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    mine = [e for e in rows if e.key == "kernel" or "modnorm_rows_kernel<false>" in e.key]
    ms = sum(e.self_device_time_total for e in mine) / 1e3
    MB = cs.ROLLOUT["members"] * cs.ROLLOUT["batch"]
    cs.log(f"[ab-modnorm] one flagship forward at MB={MB}: device busy {busy:.2f} ms; kernel 4 "
           f"{ms:.3f} ms in {sum(e.count for e in mine)} launches ({[e.key[:60] for e in mine]}) "
           f"({card})")
    del net, call, prof
    torch.cuda.empty_cache()


def epilogue_backward(cs, card: str) -> None:
    """The plain vjp of kernels 4's and 3's epilogues at the flagship's B =
    4 (32,768 tokens, D = 1056, wo 1056 x 1056), every input requiring its
    gradient as in the sCM step."""
    import numpy as np
    import torch

    from swift_torch.ops.modnorm import fused_matmul_modnorm_residual, fused_modnorm_residual

    t = cs._tensor(np.random.default_rng(1))
    gh, gw = cs.GRID
    B, D = 4, cs.DIM
    epilogue = (t((B, gh, gw, D)), 1.0 + t((D,), 0.1, torch.float32),
                t((D,), 0.1, torch.float32), t((B, D), 0.2), t((B, D), 0.2))
    cases = (("_Modnorm (kernel 4)", fused_modnorm_residual, (t((B, gh, gw, D), 3.0),) + epilogue),
             ("_MatmulModnorm (kernel 3)", fused_matmul_modnorm_residual,
              (t((B, gh, gw, D)), t((D, D), D ** -0.5)) + epilogue))
    for label, fused, args in cases:
        leaves = [a.detach().requires_grad_() for a in args]
        with torch.enable_grad():
            out = fused(*leaves)
        dout = torch.randn_like(out)

        def backward():
            return torch.autograd.grad(out, leaves, dout, retain_graph=True)

        single, queued = cs.time_ms(backward), cs.queued_ms(backward)
        cs.log(f"[ab-modnorm] {label}.backward, the plain vjp, at B={B} ({B * gh * gw} tokens, "
               f"D={D}): {single:.3f} ms single, {queued:.3f} ms queued ({card})")
        del leaves, out, dout
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs

    card = cs.phase_environment()
    cs.phase_build()
    cs.log(f"[ab-modnorm] checkout {root}")
    t = cs._tensor(np.random.default_rng(0))
    for (B, (gh, gw)), label, reps in (((2, cs.GRID), "B=2", 20),
                                       ((1, cs.QUARTER_GRID), "0.25° B=1", 5)):
        y, r, dy, dr = (t((B, gh, gw, cs.DIM), s) for s in (3.0, 1.0, 3.0, 1.0))
        g, b = 1.0 + t((cs.DIM,), 0.1, torch.float32), t((cs.DIM,), 0.1, torch.float32)
        msc, msh, dmsc, dmsh = (t((B, cs.DIM), 0.2) for _ in range(4))
        for name, args in (("modnorm_residual", (y, r, g, b, msc, msh)),
                           ("modnorm_residual_tangent", (y, dy, dr, g, b, msc, dmsc, dmsh))):
            with torch.no_grad():
                kernel_rows(name, cs.KERNELS[name][0], args, f"{label} {gh}x{gw} D={cs.DIM}",
                            reps, cs)
        del y, r, dy, dr
        torch.cuda.empty_cache()
    forward_profile(cs, card)
    epilogue_backward(cs, card)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
