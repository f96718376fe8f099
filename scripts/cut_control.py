"""Read the sCM cuts' bf16 control on more than one seed, and hold the cuts'
limits to faults planted on purpose, on the card.

    python scripts/cut_control.py [--seeds 0 1] [--out chiprun_out/cut_control.json]

For the two cuts of ``chip_smoke.py`` that run a control, path B's
(``WIN8_SCM``: the flagship width on 8x8 windows, depth 2, batch 2) and
path A's (``TINY_CUT``: ``synthetic-tiny-scm``'s model, batch 4), at each
seed: weights from ``chip_smoke.random_weights(seed)``, draws from the seed;
the plain path in fp32 and in bf16 (the control) on the card; the kernels'
run as the port ships it; and the kernels' run with one change made at a
time by replacing a function of the port in memory (no file changes):

* ``no_row_term``: kernel 22b without the row term, dS = p·dp (its plain
  version so changed, on the card, in the kernel's place);
* ``no_p_dv``: kernel 22t without its p·dv term (the kernel given dv = 0);
* ``p_rounded_first``: kernel 22b with p rounded to bf16 before dS is
  formed, dS = bf16(p)·(dp − Σ bf16(p)·dp), instead of dS rounded after;
* ``scale_from_fp32_ds`` (not a fault: the other design, run on the
  control too): the logit scale's gradient Σ dS·(q̂·k̂ᵀ) / scale from the
  fp32 dS, as kernel 6 forms it, in place of the gradient through
  dq̂ = bf16(dS)·k̂ that the JAX package and the port take.

Each run is checked by ``chip_smoke.check_cut`` with the cut's own limits
and control rule; a planted fault should fail it. Prints one line a run and
writes them all as JSON to ``--out``. Needs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import torch
from torch.autograd import forward_ad

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from swift_torch import config as cfglib  # noqa: E402
from swift_torch.ops import block_attention, window_attention as wa  # noqa: E402


def _r(a):
    return a.to(torch.bfloat16).float()


def _bwd(q, k, v, do, p_first: bool, row_term: bool = True):
    """22b's plain formulas with the TPU rounding points, on the card, with
    one of the planted changes."""
    kt = lambda a: a.transpose(-1, -2)  # noqa: E731
    p = torch.softmax(_r(q) @ kt(_r(k)), dim=-1)
    dp = _r(do) @ kt(_r(v))
    pp = _r(p) if p_first else p
    ds = pp * (dp - torch.sum(pp * dp, -1, keepdim=True)) if row_term else p * dp
    return ((_r(ds) @ _r(k)).to(q.dtype), (kt(_r(ds)) @ _r(q)).to(k.dtype),
            (kt(_r(p)) @ _r(do)).to(v.dtype))


class _Fp32DsScale(torch.autograd.Function):
    """The core from the fp32 normalize(q), k̂, v and the scale, the logit
    scale's gradient from the fp32 dS."""

    @staticmethod
    def forward(qn, k, v, scale):
        return wa.window_attention((qn * scale[None, :, None, None]).to(v.dtype), k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, do):
        qn, k, v, scale = ctx.saved_tensors
        q = (qn * scale[None, :, None, None]).to(v.dtype)
        dq, dk, dv = wa.window_attention_bwd(q, k, v, do.to(v.dtype))
        s = _r(q) @ _r(k).transpose(-1, -2)
        p = torch.softmax(s, dim=-1)
        dp = _r(do) @ _r(v).transpose(-1, -2)
        ds = p * (dp - torch.sum(p * dp, -1, keepdim=True))
        dscale = (ds * s).sum((0, 2, 3)) / scale
        return (dq.float() * scale[None, :, None, None]).to(qn.dtype), dk, dv, dscale


def _fp32_ds_design(q, k, v, scale, _port=wa.fused_window_attention):
    taped = any(forward_ad.unpack_dual(t).tangent is not None for t in (q, k, v))
    if taped or not torch.is_grad_enabled():
        return _port(q, k, v, scale)
    kn = wa._normalize(k.float()).to(v.dtype)
    return _Fp32DsScale.apply(wa._normalize(q.float()), kn, v, scale.float())


CHANGES = {
    "no_row_term": (wa, "window_attention_bwd",
                    lambda q, k, v, do: _bwd(q, k, v, do, False, row_term=False)),
    "no_p_dv": (wa, "window_attention_tangent",
                lambda q, k, v, dq, dk, dv, _f=wa.window_attention_tangent:
                _f(q, k, v, dq, dk, torch.zeros_like(dv))),
    "p_rounded_first": (wa, "window_attention_bwd",
                        lambda q, k, v, do: _bwd(q, k, v, do, True)),
    "scale_from_fp32_ds": (block_attention, "fused_window_attention", _fp32_ds_design),
}


@contextlib.contextmanager
def changed(name: str | None):
    if name is None:
        yield
        return
    module, attr, fn = CHANGES[name]
    old = getattr(module, attr)
    fn.launches = 0  # the kernel's wrapper counts its launch on the name it is bound to
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, old)


def cuts(seed: int):
    """(slice, config, depth-2 state dict at ``seed``) of both cuts."""
    win8 = cs.WIN8_SCM
    tiny_cfg = cfglib.compose("train", [f"experiment={cs.TINY_EXPERIMENT}"])
    tiny = dataclasses.replace(cs.TINY_CUT, model=dict(tiny_cfg["model"]))
    for sl, cfg in ((win8, cs.train_config(win8.experiment, *win8.overrides, cut=win8.cut)),
                    (tiny, tiny_cfg)):
        net = cs.build_net(2, torch.float32, sl.model, sl.res, sl.variables, sl.forcings)
        cs.random_weights(net, seed)
        yield sl, cfg, {k: v.detach().float() for k, v in net.state_dict().items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--out", default=os.path.join(cs.ROOT, "chiprun_out", "cut_control.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cs.log(cs.gpu_line())
    cs.phase_build()
    rows = []
    for seed in args.seeds:
        for sl, cfg, sd in cuts(seed):
            ref, ref_dF = cs.scm_cut_runs(cfg, sd, sl, ("cpu", "control"), seed=seed + 4)
            variants = [None, "no_row_term", "no_p_dv", "p_rounded_first"]
            if sl.tag != "tiny":
                variants.append("scale_from_fp32_ds")
            for name in variants:
                keys = ("cuda", "control") if name == "scale_from_fp32_ds" else ("cuda",)
                with changed(name):
                    out, dF = cs.scm_cut_runs(cfg, sd, sl, keys, seed=seed + 4)
                out, dF = {**ref, **out}, {**ref_dF, **dF}
                tag = f"{sl.tag} seed {seed} {name or 'port'}"
                try:
                    got = cs.check_cut(tag, out, dF, sl.cut_tols, sl.control, sl.cut_batch,
                                       sl.plain_on)
                    passed = True
                except AssertionError as e:
                    got, passed = {"error": str(e)[:400]}, False
                l2 = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
                scales = {n: {k: l2(out[k][1][n], ref["cpu"][1][n]) for k in ("cuda", "control")}
                          for n in ref["cpu"][1] if n.endswith(cs.LOGIT_SCALE)}
                rows.append({"cut": sl.tag, "seed": seed, "change": name or "port",
                             "passed": passed, "scales": scales, **got})
                cs.log(f"[cut-control] {tag}: {'passes' if passed else 'FAILS'} the cut's "
                       f"limits; logit scales (kernels, control): "
                       + json.dumps({n: [f"{e['cuda']:.3e}", f"{e['control']:.3e}"]
                                     for n, e in scales.items()}))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    cs.log(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
