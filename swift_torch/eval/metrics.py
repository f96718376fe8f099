"""Offline forecast evaluation: lat-weighted RMSE / fair CRPS / SSR.

The port's counterpart of ``swift_tpu/eval/metrics.py`` (reference:
src/swift/eval/metrics.py): ``python -m swift_torch.eval.metrics --truth
truth.zarr --pred forecast.zarr`` walks the prediction's lead times ×
variables × pressure levels, computes the ensemble-mean lat-weighted RMSE
(:39-65), the fair-kernel CRPS (:68-105) and the spread-skill ratio
(:108-134), prints the headline Z500/T2M lines and writes
``evaluation_metrics.json`` next to the prediction store. The same metric
names, lead-time walk and level naming as the JAX package.

The metrics run in torch on float32 tensors, on the card unless the caller
asks for the CPU (``--device cpu``); the latitude weights are numpy, as in
the JAX package. The CRPS pairwise term (B, N, N, H, W) is formed one
sample at a time (0.6 GB a sample and variable at 0.25° with N = 12).
The stores are read with the port's zarr_lite.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from swift_torch.data.constants import DEFAULT_PRESSURE_LEVELS, PRESSURE_LEVEL_VARS
from swift_torch.utils import zarr_lite
from swift_torch.utils.device import resolve_device


def _w_lat(lat: np.ndarray) -> np.ndarray:
    w = np.cos(np.deg2rad(lat))
    return (w / w.mean()).astype(np.float32)


def _as(a, device) -> torch.Tensor:
    a = a if isinstance(a, torch.Tensor) else np.asarray(a)
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _weights(lat, device, shape) -> torch.Tensor:
    return torch.as_tensor(_w_lat(np.asarray(lat)), device=device).reshape(shape)


def lat_weighted_rmse(pred, y, lat, device="cuda") -> float:
    """Ensemble-mean lat-weighted RMSE. pred: (B, [N,] H, W); y: (B, H, W).
    Mean over the batch of each sample's sqrt of the lat-weighted MSE."""
    dev = resolve_device(str(device))
    pred, y = _as(pred, dev), _as(y, dev)
    if pred.ndim == 4:
        pred = pred.mean(dim=1)
    err = (pred - y) ** 2
    w = _weights(lat, dev, (1, -1, 1))
    return float(torch.sqrt((err * w).mean(dim=(-2, -1))).mean())


def lat_weighted_crps(pred, y, lat, device="cuda") -> float:
    """Fair kernel CRPS. pred: (B, N, H, W); y: (B, H, W)."""
    dev = resolve_device(str(device))
    pred, y = _as(pred, dev), _as(y, dev)
    B, N, H = pred.shape[0], pred.shape[1], pred.shape[-2]
    w = _weights(lat, dev, (1, 1, H, 1))
    error_term = ((pred - y[:, None]).abs() * w).mean()
    spread = torch.stack([
        ((pred[b][:, None] - pred[b][None, :]).abs() * w).mean(dim=(-2, -1)).sum()
        / (2 * N * (N - 1))
        for b in range(B)
    ])
    return float(error_term - spread.mean())


def lat_weighted_spread_skill_ratio(pred, y, lat, device="cuda") -> float:
    """SSR = spread / ensemble-mean RMSE. At lead 0 both are ~0 (the members
    share the analysis): 0/0 is 0, so the metric stays finite."""
    dev = resolve_device(str(device))
    pred = _as(pred, dev)
    rmse = lat_weighted_rmse(pred, y, lat, dev)
    var = pred.var(dim=1, correction=1)  # (B, H, W)
    spread = float(torch.sqrt((var * _weights(lat, dev, (1, -1, 1))).mean(dim=(-2, -1))).mean())
    if rmse <= 1e-12:
        return 0.0 if spread <= 1e-12 else float("inf")
    return spread / rmse


def evaluate(truth_path: str, pred_path: str, device="cuda") -> dict:
    """Every metric of the prediction store against the truth store, by
    ``{metric}_{variable[_level]}_{lead}h``."""
    dev = resolve_device(str(device))
    truth = zarr_lite.open_group(truth_path)
    pred = zarr_lite.open_group(pred_path)

    lat = np.asarray(truth["latitude"])
    truth_times = np.asarray(truth["time"])
    init_times = np.asarray(pred["time"])
    pred_td = np.asarray(pred["prediction_timedelta"])

    time_to_idx = {t: i for i, t in enumerate(truth_times)}
    init_idxs = np.array([time_to_idx[t] for t in init_times])
    dt_truth = (truth_times[1] - truth_times[0]).astype("timedelta64[h]").astype(int)

    coord_names = {"time", "latitude", "longitude", "level", "number", "prediction_timedelta"}
    data_vars = [v for v in pred.array_names() if v not in coord_names]
    level_values = (np.asarray(pred["level"]).tolist() if "level" in pred
                    else DEFAULT_PRESSURE_LEVELS)

    all_metrics: dict[str, float] = {}
    for j, delta in enumerate(pred_td):
        lead_h = delta.astype("timedelta64[h]").astype(int)
        offset = int(lead_h) // int(dt_truth)
        tgt_idxs = init_idxs + offset
        if tgt_idxs.max() >= len(truth_times):
            continue

        for var in data_vars:
            p_full = pred[var]
            if var in PRESSURE_LEVEL_VARS and len(p_full.shape) == 6:
                p_block = p_full[:, :, j:j + 1][:, :, 0]  # (B, N, L, H, W)
                t_block = np.stack([truth[var][int(i)] for i in tgt_idxs])
                # a variable's own levels attribute wins over the shared level coord
                var_levels = p_full.attrs.get("levels", level_values)
                for lvl in range(p_full.shape[3]):
                    pressure = var_levels[lvl] if lvl < len(var_levels) else lvl
                    _update(all_metrics, f"{var}_{pressure}", lead_h, p_block[:, :, lvl],
                            t_block[:, lvl], lat, dev)
            else:
                p_arr = p_full[:, :, j:j + 1][:, :, 0]  # (B, N, H, W)
                t_arr = np.stack([truth[var][int(i)] for i in tgt_idxs])
                _update(all_metrics, var, lead_h, p_arr, t_arr, lat, dev)

        for nm, val in all_metrics.items():
            if nm.endswith(f"_{lead_h}h") and any(
                    k in nm for k in ("geopotential_500", "2m_temperature")):
                print(f"{nm}: {val:.4f}")

    return all_metrics


def _update(metrics, name, lead_h, p_arr, t_arr, lat, device):
    p, t = _as(p_arr, device), _as(t_arr, device)
    metrics[f"rmse_{name}_{lead_h}h"] = lat_weighted_rmse(p, t, lat, device)
    if p.shape[1] > 1:
        metrics[f"crps_{name}_{lead_h}h"] = lat_weighted_crps(p, t, lat, device)
        metrics[f"ssr_{name}_{lead_h}h"] = lat_weighted_spread_skill_ratio(p, t, lat, device)


def nest(metrics: dict) -> dict:
    """metric -> lead -> variable, the layout of ``evaluation_metrics.json``
    (reference metrics.py:229-267)."""
    nested: dict = {}
    for key, val in metrics.items():
        mtype, rest = key.split("_", 1)
        var, lead = rest.rsplit("_", 1)
        nested.setdefault(mtype, {}).setdefault(lead, {})[var] = val
    return nested


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--truth", required=True, help="truth zarr store")
    p.add_argument("--pred", required=True, help="prediction zarr store")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device of the metric math (the CPU only when asked for)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    metrics = evaluate(args.truth, args.pred, device)
    print(f"evaluated in {time.time() - t0:.2f}s")

    out = os.path.join(os.path.dirname(args.pred), "evaluation_metrics.json")
    with open(out, "w") as f:
        json.dump(nest(metrics), f, indent=2)
    print(f"metrics written to {out}")
    return metrics


if __name__ == "__main__":
    main()
