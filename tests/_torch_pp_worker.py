"""One rank of the port's pipeline-parallel CPU tests (tests/test_torch_pipeline.py).

``python tests/_torch_pp_worker.py <dir>``, launched as 2, 3 or 4 processes
with ``SWIFT_COORDINATOR``/``SWIFT_NUM_PROCESSES``/``SWIFT_PROCESS_ID``
(gloo), reads ``<dir>/spec.json`` (the pipe size and the cases) and, for
each case, ``<case>.npz`` (one process's weights as the converter writes
them, ``model.``-prefixed, and the inputs x, t, aux) that the test wrote;
lays the ranks out data × pipe (``parallel.mesh.init_layout(pipe=S)``),
builds this rank's stage (``SwinV2(pipe_stages=S, pipe_stage=s)``, the
stage's entries by ``parallel.pipeline.stage_state_dict``) and writes
``<dir>/rank<r>.pt``: for each case the pipelined output, and for a case
with ``grads`` the gradients of mean(y²) through the pipeline, the
replicated ones summed over the pipe group (``reduce_replicated_grads``)
and, with a data axis, every one summed over the data group, under the
whole network's names. It imports only the port, does nothing on import
and loads no JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from swift_torch.models.swinv2 import SwinV2
from swift_torch.parallel import mesh
from swift_torch.parallel.pipeline import (
    pipelined_swinv2_forward,
    reduce_replicated_grads,
    stage_state_dict,
)

# tests/test_pipeline.py's tiny geometry, fp32
GEOMETRY = dict(img_resolution=(16, 32), in_channels=8, out_channels=5, window_size=(4, 4),
                shift_size=(2, 2), patch_size=(2, 2), dim=32, heads=4, dtype=torch.float32)


def build(depth: int, aux: bool, weights: dict, stages: int = 1, stage: int = 0) -> SwinV2:
    """The tiny SwinV2 (``auxiliary_dim`` 1 with aux), or stage ``stage`` of
    ``stages`` of it, with the whole network's ``weights`` (``model.``-
    prefixed numpy arrays)."""
    net = SwinV2(depth=depth, auxiliary_dim=1 if aux else 0, remat_layers=False,
                 pipe_stages=stages, pipe_stage=stage, **GEOMETRY)
    sd = {k[len("model."):]: torch.from_numpy(np.array(v)) for k, v in weights.items()
          if k.startswith("model.")}
    net.load_state_dict(stage_state_dict(sd, depth, stages, stage) if stages > 1 else sd)
    return net


def global_name(name: str, first_layer: int) -> str:
    """A stage's parameter name under the whole network's block index."""
    parts = name.split(".")
    if parts[:2] == ["transformer", "layers"]:
        parts[2] = str(int(parts[2]) + first_layer)
    return ".".join(parts)


def run_case(case: dict, arrays: dict, lay: mesh.Layout) -> dict:
    net = build(case["depth"], case["aux"], arrays, lay.pipe, lay.pipe_rank)
    x, t = torch.from_numpy(arrays["x"]), torch.from_numpy(arrays["t"])
    aux = torch.from_numpy(arrays["aux"]) if case["aux"] else None
    kw = dict(n_micro=case["n_micro"], data_axis="data" if case.get("data_axis") else None)
    out = {}
    if not case.get("grads"):
        with torch.no_grad():
            out["y"] = pipelined_swinv2_forward(net, x, t, aux, **kw)
        return out
    y = pipelined_swinv2_forward(net, x, t, aux, **kw)
    (y ** 2).mean().backward()
    reduce_replicated_grads(net, lay)
    grads = {n: p.grad for n, p in net.named_parameters()}
    if case.get("data_axis"):  # every data row's share of the whole batch's loss
        mesh.all_reduce_sum(list(grads.values()), lay.data_group)
    out["y"] = y.detach()
    out["grads"] = {global_name(n, net.first_layer): g for n, g in grads.items()}
    out["first_layer"] = net.first_layer
    return out


def main(workdir: str) -> None:
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    assert mesh.maybe_initialize_distributed("cpu")
    lay = mesh.init_layout(pipe=spec["pipe"])
    torch.manual_seed(0)
    results = {"layout": [lay.data, lay.pipe, lay.data_rank, lay.pipe_rank]}
    for case in spec["cases"]:
        arrays = dict(np.load(os.path.join(workdir, f"{case['name']}.npz")))
        results[case["name"]] = run_case(case, arrays, lay)
    r = mesh.rank()
    torch.save(results, os.path.join(workdir, f"rank{r}.pt"))
    mesh.barrier()
    print(f"PP_WORKER_OK rank={r}")


if __name__ == "__main__":
    main(sys.argv[1])
