"""Time kernels 2 and 15, the attention forward, against an earlier build
and a composition of library calls, on the card.

    python scripts/probe_attention_fwd.py [--parent DIR] [--also NAME=DIR] [--variants A,B]
        [--out chiprun_out/attention_fwd.json]

The committed ``swift_torch/csrc/block_attention.cu`` is built alone into a
library of its own, and beside it variants, each the committed source with
one change made by text substitution in a temporary copy (no file of the
repo changes):

* ``no_normalise``, ``no_exp``, ``one_pv_step``, ``one_qk_step``,
  ``no_store`` (wrong outputs, not checked): the in-place normalise of q
  and k left out, the softmax's exp left out, one of the 16
  k16 steps of p·v, one of the DP/16 of q̂·k̂ᵀ, the output's global stores
  left out -- what each part costs on the critical path.

With ``--parent DIR``, a copy of an earlier
``swift_torch/csrc`` (``git archive <commit> swift_torch/csrc | tar -x -C
DIR --strip-components 2``) whose ``block_attention.cu`` has kernels 2 and
15 in ``swift_block_attention`` and ``swift_tiled_attention`` is built and
timed too. Shapes: the flagship at B = 2 (64x128 tokens, 16x16 windows)
with 12x88 heads at shifts (8, 8) and (0, 0) and 8x128 heads at (8, 8),
kernel 15 there on the qkv rolled by (8, 8); and kernel 15 at 0.25° (B = 1,
368x720 tokens, 8x128 heads).

Every checked build is checked at every shape against the plain version, within
2e-2 of max|plain|, and its kernel 15 on rolled qkv against its kernel 2
bit for bit. Then, in turns (the builds in order, then in reverse), each
shape is timed as the median of 5 rounds of 20 calls queued back to back
between two CUDA events (the device's time), and once beside them the
composition ``chip_smoke.COMPOSITION`` (``torch.roll``, window partition,
the fp32 normalise rounded to bf16, ``F.scaled_dot_product_attention`` at
scale 1, the inverse). Prints the times and writes them as JSON. Needs one
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import COMPOSITION  # noqa: E402
from swift_torch.ops import block_attention  # noqa: E402
from scripts import probe_build  # noqa: E402
from scripts.probe_linear_variants import queued_ms  # noqa: E402

TOL = 2e-2
P, I = ctypes.c_void_p, ctypes.c_int
SOURCE = "block_attention.cu"
KERNELS = ("attn_fwd_kernel", "block_attn_kernel", "tiled_attn_kernel")
VARIANTS = {
    "committed": [],
    "no_normalise": [("for (int r = tid / 8; r < rows; r += THREADS / 8) {",
                      "for (int r = tid / 8; r < 0; r += THREADS / 8) {")],
    "no_exp": [("s[i] = exp2f((s[i] - m[(i >> 1) & 1]) * kLog2e);",
                "s[i] = s[i] - m[(i >> 1) & 1];")],
    "one_pv_step": [("for (int k = 0; k < 16; ++k) wgmma_m64nNk16_rs<DP>",
                     "for (int k = 0; k < 1; ++k) wgmma_m64nNk16_rs<DP>")],
    "one_qk_step": [("for (int k = 0; k < DP / 16; ++k)\n"
                     "          wgmma_m64nNk16<256>(s, wgmma_desc(Qc",
                     "for (int k = 0; k < 1; ++k)\n"
                     "          wgmma_m64nNk16<256>(s, wgmma_desc(Qc")],
    "no_store": [("bulk_store(out + token(qb * kQB + tid) * ofeat + col, rows + tid * LDO, d * 2);",
                  "")],
}
UNCHECKED = ("no_normalise", "no_exp", "one_pv_step", "one_qk_step", "no_store")
# name: (B, (gh, gw), heads, d, shift); "tiled" shapes run kernel 15 on qkv rolled by the shift
SHAPES = {
    "k2 12x88 shift (8, 8)": (2, (64, 128), 12, 88, (8, 8)),
    "k2 12x88 shift (0, 0)": (2, (64, 128), 12, 88, (0, 0)),
    "k2 8x128 shift (8, 8)": (2, (64, 128), 8, 128, (8, 8)),
    "k15 12x88 rolled (8, 8)": (2, (64, 128), 12, 88, (8, 8)),
    "k15 0.25° 8x128": (1, (368, 720), 8, 128, (0, 0)),
}
WINDOW = (16, 16)


def bind(name: str, dll: ctypes.CDLL, src: Path) -> None:
    dll.swift_block_attention.argtypes = [P, P, P] + [I] * 9 + [P]
    dll.swift_tiled_attention.argtypes = [P, P, P] + [I] * 7 + [P]


def inputs(rng, B, grid, heads, d, shift):
    a = rng.standard_normal((B, *grid, 3 * heads * d), dtype=np.float32)
    qkv = torch.from_numpy(a).to("cuda", torch.bfloat16)
    scale = torch.exp(0.3 * torch.from_numpy(rng.standard_normal(heads, dtype=np.float32))
                      + np.log(10.0)).cuda()
    rolled = torch.roll(qkv, (-shift[0], -shift[1]), (1, 2))
    return qkv, rolled, scale


def calls(dll, key, t, out, stream):
    """The launch of ``key``'s kernel through ``dll``, writing ``out``."""
    B, (gh, gw), heads, d, shift = SHAPES[key]
    qkv, rolled, scale = t
    if key.startswith("k2"):
        return lambda: dll.swift_block_attention(qkv.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                                 B, gh, gw, heads, d, *WINDOW, *shift, stream)
    return lambda: dll.swift_tiled_attention(rolled.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                             B, gh, gw, heads, d, *WINDOW, stream)


def main() -> int:
    ap = argparse.ArgumentParser()
    probe_build.add_args(ap, VARIANTS)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "attention_fwd.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_attention_fwd: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = probe_build.build_all(Path(tmp), args, VARIANTS, SOURCE, KERNELS, bind)
        stream = torch.cuda.current_stream().cuda_stream
        rng = np.random.default_rng(0)
        times: dict = {}
        for key, (B, grid, heads, d, shift) in SHAPES.items():
            t = inputs(rng, B, grid, heads, d, shift)
            qkv, rolled, scale = t
            k2 = key.startswith("k2")
            plain_args = (qkv, scale, heads, WINDOW, shift) if k2 else (rolled, scale, heads,
                                                                          WINDOW)
            want = block_attention.reference_block_attention(*plain_args).float()
            ref = want.abs().max().item()
            outs = {}
            for name, dll in libs.items():
                out = torch.empty(B, *grid, heads * d, device="cuda", dtype=torch.bfloat16)
                fn = calls(dll, key, t, out, stream)
                code = fn()
                if code and name in VARIANTS and name != "committed":
                    print(f"{name} {key}: launch failed ({code}), dropped", flush=True)
                    continue
                if code:
                    raise RuntimeError(f"{name} {key}: launch failed ({code})")
                torch.cuda.synchronize()
                outs[name] = (fn, out)
                if name in UNCHECKED:
                    continue
                err = (out.float() - want).abs().max().item()
                print(f"{name} {key}: max err {err:.3e} of max|plain| {ref:.3e}", flush=True)
                if not (torch.isfinite(out).all() and err <= TOL * ref):
                    raise AssertionError(f"{name} {key} is off its plain version: {err}")
                if not k2 and any(shift):  # kernel 15 on rolled qkv against kernel 2
                    k2_out = torch.empty_like(out)
                    dll.swift_block_attention(qkv.data_ptr(), scale.data_ptr(), k2_out.data_ptr(),
                                              B, *grid, heads, d, *WINDOW, *shift, stream)
                    same = torch.equal(torch.roll(out, shift, (1, 2)), k2_out)
                    print(f"{name} {key}: equal to kernel 2 bit for bit: {same}", flush=True)
                    if not same:
                        raise AssertionError(f"{name}: kernel 15 differs from kernel 2")
            del want
            order = list(outs) + list(outs)[::-1]
            for name in order:
                times.setdefault(f"{name} {key}", []).append(queued_ms(outs[name][0]))
            comp = (COMPOSITION["block_attention"](*plain_args) if k2 else
                    COMPOSITION["tiled_block_attention"](*plain_args))
            times[f"composition {key}"] = [queued_ms(comp)]
            print(f"{key} (ms, queued): " + "; ".join(
                f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items()
                if key in k), flush=True)
            del t, qkv, rolled, outs
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "window": WINDOW, "shapes": SHAPES, "ms": times},
                              indent=1))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
