"""``chip_smoke.py``'s data-, tensor- or pipeline-parallel phase alone, after the build.

    python scripts/smoke_dp.py                               # 2 ranks share the card, gloo
    python scripts/smoke_dp.py --world 4 --backend nccl      # a card a rank (4 cards)
    python scripts/smoke_dp.py --phase tp                    # data 1 x model 2, gloo
    python scripts/smoke_dp.py --phase tp --world 4 --backend nccl  # data 2 x model 2
    python scripts/smoke_dp.py --phase pp                    # data 1 x pipe 2, gloo
    python scripts/smoke_dp.py --phase pp --world 4 --backend nccl  # data 2 x pipe 2

Runs ``phase_environment``, ``phase_build`` and ``phase_dp`` (with
``--phase tp``: ``phase_tp``, ``chip_smoke.TP`` in place of DP; with
``--phase pp``: ``phase_pp``, ``chip_smoke.PP``) with that spec set from
the flags; each rank's log and result are
copied into ``chiprun_out/`` (git-ignored) before the work directory goes.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--phase", choices=["dp", "tp", "pp"], default="dp")
    p.add_argument("--world", type=int)
    p.add_argument("--backend", choices=["gloo", "nccl"])
    args = p.parse_args()
    spec, phase = {"dp": (cs.DP, cs.phase_dp), "tp": (cs.TP, cs.phase_tp),
                   "pp": (cs.PP, cs.phase_pp)}[args.phase]
    backend = args.backend or spec["backend"]
    spec.update(world=args.world or spec["world"], backend=backend,
                share_card=backend == "gloo")
    card = cs.phase_environment()
    cs.timed("build", cs.phase_build)
    out = os.path.join(cs.ROOT, "chiprun_out")
    try:
        cs.timed(args.phase, phase, card)
    finally:
        os.makedirs(out, exist_ok=True)
        for f in glob.glob(os.path.join(cs.WORK, args.phase, "rank*.*")):
            shutil.copy(f, os.path.join(out, f"{args.phase}_{backend}_{os.path.basename(f)}"))
        shutil.rmtree(cs.WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
