"""Hydra-compatible config composition (no hydra dependency).

The port's own copy of ``swift_tpu/config.py``. One config tree serves both
packages: :data:`DEFAULT_CONFIG_DIR` is the YAML tree under
``swift_tpu/configs/``, read as data files by path (nothing of the JAX
package is imported).

Reads the same YAML tree schema as the reference (reference:
src/swift/configs/, hydra semantics per train.py:135 and the
``@package _global_`` experiment overlays) so configs are interchangeable
(BASELINE.md). Supported subset — everything the reference tree uses:

  * ``defaults`` lists with ``_self_`` placement, group entries
    (``trainer: defaults``), absolute groups (``/data: era5-flare-1.4``),
    same-group entries (``- defaults``), null entries (``finetune: null``),
    and ``override /loss/noise: loguniform`` directives;
  * ``# @package <pkg>`` headers (``_global_`` or a dotted path);
  * CLI overrides: group selection (``experiment=...``,
    ``loss/noise=lognormal``), value overrides (``trainer.total_kimg=10``),
    additions (``+key=val``), deletions (``~key``);
  * ``${a.b}`` interpolation and ``${oc.env:VAR,default}``.

The ``_target_`` instantiation zoo is replaced by explicit builder functions
in ``swift_torch.factory`` (a light registry instead of arbitrary imports).
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Optional

import yaml

DEFAULT_CONFIG_DIR = Path(__file__).resolve().parent.parent / "swift_tpu" / "configs"

_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)")
_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class ConfigError(Exception):
    pass


_SCI_RE = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")


def _normalize_numbers(value):
    """PyYAML (YAML 1.1) reads '1e-11' as a string; OmegaConf/Hydra read it
    as a float. Normalize for interchangeability."""
    if isinstance(value, str) and _SCI_RE.match(value):
        return float(value)
    if isinstance(value, dict):
        return {k: _normalize_numbers(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_normalize_numbers(v) for v in value]
    return value


def _read_yaml(path: Path) -> tuple[dict, Optional[str]]:
    text = path.read_text()
    package = None
    for line in text.splitlines()[:5]:
        m = _PACKAGE_RE.match(line.strip())
        if m:
            package = m.group(1)
            break
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: top level must be a mapping")
    return _normalize_numbers(data), package


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _set_path(cfg: dict, dotted: str, value: Any, create: bool = True):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            if not create:
                raise ConfigError(f"missing config path: {dotted}")
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def _get_path(cfg: dict, dotted: str, default=..., delete: bool = False):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if not isinstance(node, dict) or k not in node:
            if default is ...:
                raise KeyError(dotted)
            return default
        node = node[k]
    if not isinstance(node, dict) or keys[-1] not in node:
        if default is ...:
            raise KeyError(dotted)
        return default
    if delete:
        return node.pop(keys[-1])
    return node[keys[-1]]


def _parse_value(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


class _Composer:
    def __init__(self, config_dir: Path, group_overrides: dict[str, Optional[str]]):
        self.dir = Path(config_dir)
        self.result: dict = {}
        # group path -> chosen name; None disables the group.
        # CLI overrides always win; config-level `override` directives only
        # redirect a group's FIRST selection (hydra defaults-tree behavior) —
        # a later explicit selection (e.g. finetune's `/optimizer: adamw`)
        # keeps its stated name.
        self.cli_overrides = dict(group_overrides)
        self.overrides: dict[str, Optional[str]] = {}
        self.chosen: dict[str, str] = {}

    # -- defaults entry parsing -------------------------------------------
    def _entry_parts(self, entry) -> tuple[bool, Optional[str], Optional[str]]:
        """Returns (is_override, group, name). group None => bare name."""
        if isinstance(entry, str):
            return False, None, entry
        if isinstance(entry, dict) and len(entry) == 1:
            (k, v), = entry.items()
            k = str(k)
            if k.startswith("override "):
                return True, k[len("override "):].strip(), v
            return False, k, v
        raise ConfigError(f"bad defaults entry: {entry!r}")

    def _resolve_group(self, group: Optional[str], current_group: str) -> str:
        if group is None:
            return current_group
        if group.startswith("/"):
            return group[1:]
        return f"{current_group}/{group}" if current_group else group

    # -- composition --------------------------------------------------------
    def compose(self, config_name: str, cli_values: list[tuple[str, str, str]]):
        # Pass 1 (hydra defaults-tree semantics): walk the whole tree only to
        # collect `override` directives, so an experiment's
        # `override /optimizer: muon` applies even though the root defaults
        # list selects the optimizer group before the experiment.
        self._process(config_name, group="", package="", collect_only=True)
        self.result = {}
        self.chosen = {}
        self._process(config_name, group="", package="")
        for kind, key, raw in cli_values:
            if kind == "set":
                _set_path(self.result, key, _parse_value(raw))
            elif kind == "add":
                _set_path(self.result, key, _parse_value(raw))
            elif kind == "del":
                _get_path(self.result, key, default=None, delete=True)
        return self.result

    def _collect_overrides(self, defaults: list, current_group: str):
        for entry in defaults:
            is_override, group, name = self._entry_parts(entry)
            if is_override:
                gpath = self._resolve_group(group, current_group)
                self.overrides.setdefault(gpath, name)

    def _process(
        self,
        config_name: str,
        group: str,
        package: Optional[str],
        collect_only: bool = False,
    ):
        path = self.dir / group / f"{config_name}.yaml"
        if not path.exists():
            raise ConfigError(f"config not found: {path}")
        data, pkg_directive = _read_yaml(path)

        if pkg_directive is not None:
            package = "" if pkg_directive == "_global_" else pkg_directive.replace("/", ".")

        defaults = data.pop("defaults", None)
        own = data

        if defaults is None:
            if not collect_only:
                self._merge(own, package)
            return

        self._collect_overrides(defaults, group)

        saw_self = any(
            (isinstance(e, str) and e == "_self_") for e in defaults
        )
        for entry in defaults:
            if isinstance(entry, str) and entry == "_self_":
                if not collect_only:
                    self._merge(own, package)
                continue
            is_override, egroup, name = self._entry_parts(entry)
            if is_override:
                continue
            gpath = self._resolve_group(egroup, group) if egroup else group
            if egroup is None:
                # bare name: same group dir, same package.
                sub_package = package
            else:
                sub_package = gpath.replace("/", ".")
            # apply selection overrides: CLI always; config-level `override`
            # directives only for the group's first selection.
            if gpath in self.cli_overrides:
                name = self.cli_overrides[gpath]
            elif gpath in self.overrides and gpath not in self.chosen:
                name = self.overrides[gpath]
            if name is None:
                continue
            self.chosen[gpath] = str(name)
            self._process(str(name), gpath, sub_package, collect_only)

        if not saw_self and not collect_only:
            # hydra 1.1+: implicit _self_ appended at the END.
            self._merge(own, package)

    def _merge(self, data: dict, package: Optional[str]):
        data = copy.deepcopy(data)
        if package:
            wrapped: dict = {}
            node = wrapped
            parts = package.split(".")
            for p in parts[:-1]:
                node[p] = {}
                node = node[p]
            node[parts[-1]] = data
            data = wrapped
        _deep_merge(self.result, data)


def _split_overrides(
    config_dir: Path, overrides: list[str]
) -> tuple[dict[str, Optional[str]], list[tuple[str, str, str]]]:
    groups: dict[str, Optional[str]] = {}
    values: list[tuple[str, str, str]] = []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            values.append(("del", ov[1:], ""))
            continue
        add = ov.startswith("+")
        if add:
            ov = ov[1:]
        if "=" not in ov:
            raise ConfigError(f"override must be key=value: {ov!r}")
        key, raw = ov.split("=", 1)
        # group selection iff the key names a config group directory and the
        # key has no dots.
        if "." not in key and (config_dir / key.replace("//", "/")).is_dir():
            groups[key] = None if raw in ("null", "None", "") else raw
        else:
            values.append(("add" if add else "set", key, raw))
    return groups, values


def compose(
    config_name: str = "train",
    overrides: Optional[list[str]] = None,
    config_dir: Optional[str | Path] = None,
) -> dict:
    """Compose a config like ``hydra.main`` would, returning a plain dict."""
    config_dir = Path(config_dir or DEFAULT_CONFIG_DIR)
    groups, values = _split_overrides(config_dir, overrides or [])
    composer = _Composer(config_dir, groups)
    cfg = composer.compose(config_name, values)
    return resolve_interpolations(cfg)


def resolve_interpolations(cfg: dict) -> dict:
    def resolve(value, seen=()):
        if isinstance(value, str):
            def repl(m):
                expr = m.group(1)
                if expr.startswith("oc.env:"):
                    spec = expr[len("oc.env:"):]
                    name, _, default = spec.partition(",")
                    return str(os.environ.get(name.strip(), default.strip()))
                if expr in seen:
                    raise ConfigError(f"interpolation cycle: {expr}")
                target = _get_path(cfg, expr, default=None)
                target = resolve(target, seen + (expr,))
                return "" if target is None else str(target)

            if _INTERP_RE.fullmatch(value):
                # whole-string interpolation preserves type
                expr = value[2:-1]
                if expr.startswith("oc.env:"):
                    spec = expr[len("oc.env:"):]
                    name, _, default = spec.partition(",")
                    return os.environ.get(name.strip(), default.strip() or None)
                return resolve(_get_path(cfg, expr, default=None), seen + (expr,))
            return _INTERP_RE.sub(repl, value)
        if isinstance(value, dict):
            return {k: resolve(v, seen) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, seen) for v in value]
        return value

    return resolve(cfg)


def save_config(cfg: dict, path: str | Path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))


def load_config(path: str | Path) -> dict:
    return yaml.safe_load(Path(path).read_text())
