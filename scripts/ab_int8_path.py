"""Time the int8 inference path of one checkout of the repo on the card:
kernel 19 (the int8 wo + post-norm) through its wrapper at the flagship's
B = 2 (12x88 heads) and at the 0.25° shapes, single calls and queued; then
``chip_smoke.py``'s int8 phase (one full-width int8 forward at MB = 4 with
exact launches, its relative RMS against the bf16 forward, both forwards'
device times, the forward by kernel under torch.profiler, the MB = 4
rollout into a store) and its 0.25° int8 forward.

    python scripts/ab_int8_path.py [--root DIR]

``--root`` names the checkout whose ``chip_smoke.py`` and ``swift_torch``
run (default: this one), so that an earlier commit, unpacked with ``git
archive <commit> | tar -x -C DIR``, runs through the same phases. To
compare two checkouts, run it on each in turns in one call (the earlier,
this, this, the earlier). Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import chip_smoke as cs

    card = cs.phase_environment()
    cs.phase_build()
    name = "matmul_modnorm_residual_int8"
    fused = cs.KERNELS[name][0]
    t = cs._tensor(np.random.default_rng(0))
    gh, gw = cs.GRID
    epilogue = (t((2, gh, gw, cs.DIM)), 1.0 + t((cs.DIM,), 0.1, cs.torch.float32),
                t((cs.DIM,), 0.1, cs.torch.float32), t((2, cs.DIM), 0.2), t((2, cs.DIM), 0.2))
    flagship = (t((2, gh, gw, 12 * 88)), t((cs.DIM, 12 * 88), (12 * 88) ** -0.5,
                                         cs.torch.float32)) + epilogue
    qh, qw = cs.QUARTER_GRID
    epilogue = (t((1, qh, qw, cs.DIM)), 1.0 + t((cs.DIM,), 0.1, cs.torch.float32),
                t((cs.DIM,), 0.1, cs.torch.float32), t((1, cs.DIM), 0.2), t((1, cs.DIM), 0.2))
    quarter = (t((1, qh, qw, 1024)), t((cs.DIM, 1024), 1024 ** -0.5, cs.torch.float32)) + epilogue
    for label, args, reps in (("B=2 12x88", flagship, 20), ("0.25° B=1 8x128", quarter, 5)):
        with cs.torch.no_grad():
            fields = cs.check_kernel(name, args, label, reps=reps)
            queued = cs.queued_ms(lambda: fused(*args), reps)
        cs.log(f"[ab-int8] {root}: kernel 19 through its wrapper at {label}: {fields['ms']:.4f} "
               f"ms single, {queued:.4f} ms queued, bound {fields['bound_ms']:.4f} ms ({card})")
    del flagship, quarter, epilogue
    cs.torch.cuda.empty_cache()
    try:
        cs.phase_int8(card, cs.MODEL, "int8")
        cs.phase_quarter_int8(card)
    finally:
        shutil.rmtree(cs.WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
