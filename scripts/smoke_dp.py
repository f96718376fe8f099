"""``chip_smoke.py``'s data-parallel phase alone, after the build.

    python scripts/smoke_dp.py                               # 2 ranks share the card, gloo
    python scripts/smoke_dp.py --world 4 --backend nccl      # a card a rank (4 cards)

Runs ``phase_environment``, ``phase_build`` and ``phase_dp`` with
``chip_smoke.DP`` set from the flags; each rank's log and result are
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
    p.add_argument("--world", type=int, default=cs.DP["world"])
    p.add_argument("--backend", choices=["gloo", "nccl"], default=cs.DP["backend"])
    args = p.parse_args()
    cs.DP.update(world=args.world, backend=args.backend, share_card=args.backend == "gloo")
    card = cs.phase_environment()
    cs.timed("build", cs.phase_build)
    out = os.path.join(cs.ROOT, "chiprun_out")
    try:
        cs.timed("dp", cs.phase_dp, card)
    finally:
        os.makedirs(out, exist_ok=True)
        for f in glob.glob(os.path.join(cs.WORK, "dp", "rank*.*")):
            shutil.copy(f, os.path.join(out, f"dp_{args.backend}_{os.path.basename(f)}"))
        shutil.rmtree(cs.WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
