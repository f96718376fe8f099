"""JAX SwinV2 params <-> the port's state dict, numpy only.

The JAX package keeps SwinV2 weights as a nested params tree, with the
transformer either stacked for ``nn.scan`` (``pairs/{even,odd}/...`` with a
leading depth//2 axis) or unrolled (``block{i}/...``); its checkpoints flatten
that tree to ``/``-joined npz keys. The port's modules carry the reference
torch model's parameter names, so this mapping is the one
``swift_tpu.models.convert.swinv2_params_to_state_dict`` defines: Flax
kernels (in, out) are torch weights (out, in) transposed, the per-head
logit scale is (heads,) in JAX and (1, heads, 1, 1) in torch. Keys carry the
``model.`` prefix of the precond wrapper.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np


def nest(flat: Mapping[str, Any]) -> dict:
    """{'a/b/c': arr} -> {'a': {'b': {'c': arr}}}."""
    out: dict = {}
    for key, val in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict:
    """Inverse of :func:`nest`."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _tree_map(fn: Callable, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _blocks(params: Mapping[str, Any]) -> list:
    """The per-layer block trees in order, from either transformer layout."""
    if "pairs" in params:
        even, odd = params["pairs"]["even"], params["pairs"]["odd"]
        n_pairs = np.shape(next(iter(flatten(even).values())))[0]
        out = []
        for j in range(n_pairs):
            out.append(_tree_map(lambda a: np.asarray(a)[j], even))
            out.append(_tree_map(lambda a: np.asarray(a)[j], odd))
        return out
    out = []
    while f"block{len(out)}" in params:
        out.append(params[f"block{len(out)}"])
    return out


def params_to_state_dict(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """JAX params (nested; ``pairs`` or ``block{i}`` layout) -> ``model.``-
    prefixed fp32 numpy state dict for :class:`swift_torch.models.precond.PassPrecond`."""
    out: dict[str, np.ndarray] = {}

    def put(key, val, transpose=False):
        v = np.asarray(val, np.float32)
        out[f"model.{key}"] = np.ascontiguousarray(v.T if transpose else v)

    put("pos_embed", params["pos_embed"])
    put("patch_embed.emb.weight", params["patch_embed"]["kernel"], True)
    put("patch_embed.emb.bias", params["patch_embed"]["bias"])
    put("latent_embed.l1.weight", params["latent_l1"]["kernel"], True)
    put("latent_embed.l1.bias", params["latent_l1"]["bias"])
    put("latent_embed.l2.weight", params["latent_l2"]["kernel"], True)
    put("latent_embed.l2.bias", params["latent_l2"]["bias"])
    for name in ("auxiliary_embed", "logvar_embed"):
        if name in params:
            put(f"{name}.weight", params[name]["kernel"], True)
            put(f"{name}.bias", params[name]["bias"])
    put("head.head.0.weight", params["head"]["kernel"], True)
    for i, blk in enumerate(_blocks(params)):
        base = f"transformer.layers.{i}"
        put(f"{base}.0.to_qkv.weight", blk["attn"]["to_qkv"]["kernel"], True)
        put(f"{base}.0.wo.weight", blk["attn"]["wo"]["kernel"], True)
        put(f"{base}.0.scale", np.asarray(blk["attn"]["scale"]).reshape(1, -1, 1, 1))
        for mod, tkey in (("attn", "0"), ("ff", "1")):
            n = blk[mod]["norm"]
            put(f"{base}.{tkey}.norm.norm.weight", n["norm"]["scale"])
            put(f"{base}.{tkey}.norm.norm.bias", n["norm"]["bias"])
            put(f"{base}.{tkey}.norm.modulation.weight", n["modulation"]["kernel"], True)
            put(f"{base}.{tkey}.norm.modulation.bias", n["modulation"]["bias"])
        put(f"{base}.1.w1.weight", blk["ff"]["w1"]["kernel"], True)
        put(f"{base}.1.w2.weight", blk["ff"]["w2"]["kernel"], True)
    return out


def state_dict_to_params(state_dict: Mapping[str, Any], depth: int,
                         scan_layers: bool = True) -> dict:
    """Inverse of :func:`params_to_state_dict`: a (``model.``-prefixed or
    bare) state dict of numpy arrays or tensors -> JAX params, in the stacked
    ``pairs`` layout when ``scan_layers`` and the depth is even (the JAX
    model's default), else ``block{i}``."""
    sd = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().float().cpu().numpy()
        sd[k[len("model."):] if k.startswith("model.") else k] = np.asarray(v, np.float32)

    def dense(prefix, bias=True):
        d = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
        if bias:
            d["bias"] = sd[f"{prefix}.bias"]
        return d

    p: dict = {
        "pos_embed": sd["pos_embed"],
        "patch_embed": dense("patch_embed.emb"),
        "latent_l1": dense("latent_embed.l1"),
        "latent_l2": dense("latent_embed.l2"),
        "head": dense("head.head.0", bias=False),
    }
    for name in ("auxiliary_embed", "logvar_embed"):
        if f"{name}.weight" in sd:
            p[name] = dense(name)

    def norm(prefix):
        return {
            "norm": {"scale": sd[f"{prefix}.norm.weight"], "bias": sd[f"{prefix}.norm.bias"]},
            "modulation": dense(f"{prefix}.modulation"),
        }

    def block(i):
        base = f"transformer.layers.{i}"
        return {
            "attn": {
                "to_qkv": dense(f"{base}.0.to_qkv", bias=False),
                "wo": dense(f"{base}.0.wo", bias=False),
                "norm": norm(f"{base}.0.norm"),
                "scale": sd[f"{base}.0.scale"].reshape(-1),
            },
            "ff": {
                "w1": dense(f"{base}.1.w1", bias=False),
                "w2": dense(f"{base}.1.w2", bias=False),
                "norm": norm(f"{base}.1.norm"),
            },
        }

    blocks = [block(i) for i in range(depth)]
    if scan_layers and depth % 2 == 0:
        stack = lambda bs: _tree_map(lambda *leaves: np.stack(leaves, 0), *bs)  # noqa: E731
        p["pairs"] = {"even": stack(blocks[0::2]), "odd": stack(blocks[1::2])}
    else:
        p.update({f"block{i}": b for i, b in enumerate(blocks)})
    return p
