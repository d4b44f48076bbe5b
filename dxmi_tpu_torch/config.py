"""Config loading and ``_target_`` instantiation for the port.

``load_yaml`` reads the repo's YAML configs with a small stdlib reader
(``parse_yaml``) that gives PyYAML's ``safe_load`` results (YAML 1.1) for the
subset those files use, so the entry points run where PyYAML is missing;
``to_yaml`` writes that subset back (a run directory's ``config.yaml``).
``merge``, ``parse_unknown_args`` and ``parse_nested_args`` are the JAX
package's (``dxmi_tpu/config.py``): deep merges and typed ``--a.b value``
overrides.

``_target_`` paths of the JAX package (``dxmi_tpu.*``) and of the reference
(``models.DxMI.*``) resolve through an alias table to the port's classes,
so the repo's configs and reference run directories build port modules.
"""
from __future__ import annotations

import ast
import copy
import importlib
import math
import re
import sys
from typing import Any, Callable, Dict, List, Tuple

_ALIASES: Dict[str, str] = {
    "dxmi_tpu.models.unet_small.UNetSmall":
        "dxmi_tpu_torch.models.unet_small.UNetSmall",
    "models.DxMI.unet_small.Model":
        "dxmi_tpu_torch.models.unet_small.UNetSmall",
    "dxmi_tpu.samplers.var.VARSampler":
        "dxmi_tpu_torch.samplers.var.VARSampler",
    "models.DxMI.var_sampler.VARSampler":
        "dxmi_tpu_torch.samplers.var.VARSampler",
    "dxmi_tpu.models.ncsnpp.NCSNpp": "dxmi_tpu_torch.models.ncsnpp.NCSNpp",
    "dxmi_tpu.models.ncsnpp.NCSNppArgs":
        "dxmi_tpu_torch.models.ncsnpp.NCSNppArgs",
    "dxmi_tpu.samplers.ddgan.DDGANSampler":
        "dxmi_tpu_torch.samplers.ddgan.DDGANSampler",
    "dxmi_tpu.trainers.dxmi.DxMITrainer":
        "dxmi_tpu_torch.trainers.dxmi.DxMITrainer",
    "models.DxMI.trainer.DxMI_Trainer":
        "dxmi_tpu_torch.trainers.dxmi.DxMITrainer",
    "dxmi_tpu.trainers.dxmi_cond.DxMITrainerCond":
        "dxmi_tpu_torch.trainers.dxmi_cond.DxMITrainerCond",
    "models.DxMI.trainer.DxMI_Trainer_Cond":
        "dxmi_tpu_torch.trainers.dxmi_cond.DxMITrainerCond",
    "dxmi_tpu.models.value.TimeIndependentValue":
        "dxmi_tpu_torch.models.value.TimeIndependentValue",
    "models.value.TimeIndependentValue":
        "dxmi_tpu_torch.models.value.TimeIndependentValue",
    "dxmi_tpu.models.igebm.IGEBMEncoder":
        "dxmi_tpu_torch.models.igebm.IGEBMEncoder",
    "models.modules.IGEBMEncoderV2":
        "dxmi_tpu_torch.models.igebm.IGEBMEncoder",
    "dxmi_tpu.models.wideresnet.WideResNet":
        "dxmi_tpu_torch.models.wideresnet.WideResNet",
    "models.wideresnet_te.wideresnet.Wide_ResNet":
        "dxmi_tpu_torch.models.wideresnet.WideResNet",
}

# YAML 1.1 plain-scalar resolution, as PyYAML's resolver does it. A float
# needs a dot (``1e-8`` stays a string, ``1.0e-06`` is a float); sexagesimal,
# octal, hex and binary numbers are outside the subset and raise.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_OTHER_NUMBER = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+"
                           r"|[-+]?0x[0-9a-fA-F_]+"
                           r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+"
                           r"(?:\.[0-9_]*)?)$")
# a block-mapping key: an identifier-like plain scalar
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.-]*)\s*:(?:\s+(.*))?$")


class YamlSubsetError(ValueError):
    """Raised for YAML outside the subset that ``parse_yaml`` reads."""


def _plain(text: str, where: str) -> Any:
    if _NULL.match(text):
        return None
    if _TRUE.match(text):
        return True
    if _FALSE.match(text):
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if _OTHER_NUMBER.match(text):
        raise YamlSubsetError(f"{where}: number form {text!r} not supported")
    if text[0] in "&*!|>%@`{" or ": " in text or text.endswith(":") \
            or " #" in text:
        raise YamlSubsetError(f"{where}: unsupported scalar {text!r}")
    return text


def _scalar(text: str, where: str) -> Any:
    """A flow scalar: quoted string, flow list of scalars, or plain."""
    text = text.strip()
    if text.startswith('"'):
        if len(text) < 2 or not text.endswith('"') or "\\" in text \
                or '"' in text[1:-1]:
            raise YamlSubsetError(f"{where}: unsupported string {text!r}")
        return text[1:-1]
    if text.startswith("'"):
        body = text[1:-1]
        if len(text) < 2 or not text.endswith("'") \
                or "'" in body.replace("''", ""):
            raise YamlSubsetError(f"{where}: unsupported string {text!r}")
        return body.replace("''", "'")
    if text.startswith("["):
        if not text.endswith("]") or "[" in text[1:-1] or "]" in text[1:-1] \
                or "{" in text:
            raise YamlSubsetError(f"{where}: unsupported flow list {text!r}")
        body = text[1:-1].strip()
        if not body:
            return []
        items = [s.strip() for s in body.split(",")]
        if not items[-1]:
            items.pop()
        if any(not s or s[0] in "'\"" for s in items):
            raise YamlSubsetError(f"{where}: unsupported flow list {text!r}")
        return [_plain(s, where) for s in items]
    return _plain(text, where)


def _strip_comment(line: str) -> str:
    """The line without its comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:[,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset of the repo's configs: block mappings, block
    sequences of scalars, flow lists of scalars, comments, quoted and plain
    scalars resolved as YAML 1.1 (ints, floats with a dot, ``.inf``,
    ``.nan``, ``null``/``~``, the YAML 1.1 booleans). Anything else (anchors,
    tags, block scalars, flow mappings, multiple documents, tabs) raises
    ``YamlSubsetError``."""
    lines: List[Tuple[int, str, int]] = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {no}: tab indentation")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.startswith(("---", "...", "%")):
            raise YamlSubsetError(f"line {no}: document markers and "
                                  "directives are not supported")
        lines.append((len(body) - len(body.lstrip(" ")), body.strip(), no))
    if not lines:
        return None
    node, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise YamlSubsetError(f"line {lines[end][2]}: bad indentation")
    return node


def _block(lines, i, indent):
    """The block node whose lines start at ``i`` with ``indent`` spaces;
    returns it and the index of the first line after it."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i, indent):
    out = []
    while i < len(lines) and lines[i][0] == indent:
        ind, body, no = lines[i]
        if not (body == "-" or body.startswith("- ")):
            break
        item = body[1:].strip()
        if not item or _KEY.match(item) or item.startswith("- "):
            raise YamlSubsetError(f"line {no}: only scalars are supported "
                                  "as sequence items")
        out.append(_scalar(item, f"line {no}"))
        i += 1
    return out, i


def _mapping(lines, i, indent):
    out: Dict[Any, Any] = {}
    while i < len(lines):
        ind, body, no = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"line {no}: bad indentation")
        m = _KEY.match(body)
        if not m:
            raise YamlSubsetError(f"line {no}: expected 'key: value', got "
                                  f"{body!r}")
        key = _plain(m.group(1).strip(), f"line {no}")
        value = m.group(2)
        i += 1
        if value is not None and value.strip():
            out[key] = _scalar(value, f"line {no}")
            continue
        nxt = lines[i] if i < len(lines) else None
        if nxt is not None and (nxt[0] > indent or (
                nxt[0] == indent and (nxt[1] == "-"
                                      or nxt[1].startswith("- ")))):
            out[key], i = _block(lines, i, nxt[0])
        else:
            out[key] = None
    return out, i


def load_yaml(path: str) -> Dict[str, Any]:
    """Read a YAML config file with ``parse_yaml`` (no PyYAML needed)."""
    with open(path) as f:
        return parse_yaml(f.read()) or {}


def _emit_scalar(v: Any) -> str:
    """A scalar as ``parse_yaml`` reads it back."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:  # YAML 1.1 floats need a dot: 1e-08 -> 1.0e-08
            mant, _, exp = r.partition("e")
            r = f"{mant}.0" + (f"e{exp}" if exp else "")
        if "e" in r and r.split("e")[1][0] not in "+-":
            r = r.replace("e", "e+")
        return r
    if isinstance(v, str):
        try:
            plain_ok = _plain(v, "") == v and v.strip() == v and "'" not in v
        except YamlSubsetError:
            plain_ok = False
        return v if plain_ok and v else "'" + v.replace("'", "''") + "'"
    raise YamlSubsetError(f"cannot write {type(v).__name__} {v!r}")


def to_yaml(cfg: Dict[str, Any], indent: int = 0) -> str:
    """``cfg`` (nested dicts of scalars and lists of scalars) as YAML that
    ``parse_yaml`` reads back equal."""
    lines = []
    pad = " " * indent
    for k, v in cfg.items():
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{k}:")
            lines.append(to_yaml(v, indent + 2).rstrip("\n"))
        elif isinstance(v, (list, tuple)):
            lines.append(f"{pad}{k}: [" + ", ".join(
                _emit_scalar(x) for x in v) + "]")
        else:
            lines.append(f"{pad}{k}: "
                         f"{'null' if isinstance(v, dict) else _emit_scalar(v)}")
    return "\n".join(lines) + "\n"


def save_yaml(cfg: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        f.write(to_yaml(cfg))


def merge(*configs: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge configs left to right (later wins, dicts merge)."""
    def _merge(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(a)
        for k, v in b.items():
            if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                out[k] = _merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        return out

    acc: Dict[str, Any] = {}
    for c in configs:
        acc = _merge(acc, c)
    return acc


def parse_arg_type(val: str) -> Any:
    """A CLI string as None, bool, int, float, list or str."""
    if val in ("None", "none", "null", "Null"):
        return None
    if val in ("True", "true"):
        return True
    if val in ("False", "false"):
        return False
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    if val.startswith("[") and val.endswith("]"):
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
    return val


def parse_unknown_args(l_args: List[str]) -> Dict[str, Any]:
    """``--key value`` pairs into a flat dict of typed values; a trailing
    unpaired token is dropped with a warning."""
    if len(l_args) % 2 == 1:
        print(f"WARNING: ignoring trailing override token {l_args[-1]!r} "
              "(overrides are --key value pairs)", file=sys.stderr)
    out: Dict[str, Any] = {}
    for i in range(len(l_args) // 2):
        key = l_args[2 * i]
        if not key.startswith("--"):
            raise ValueError(f"expected --key, got {key!r}")
        out[key[2:]] = parse_arg_type(l_args[2 * i + 1])
    return out


def parse_nested_args(d_cmd_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Dot-separated keys into nested dicts."""
    out: Dict[str, Any] = {}
    for key, val in d_cmd_cfg.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def resolve_target(path: str) -> Callable:
    target = _ALIASES.get(path, path)
    if not target.startswith("dxmi_tpu_torch."):
        raise KeyError(f"_target_ {path!r} has no port in dxmi_tpu_torch")
    module, _, name = target.rpartition(".")
    return getattr(importlib.import_module(module), name)


def instantiate(cfg: Any, **overrides: Any) -> Any:
    """Build the object a config node names in ``_target_``; nested nodes
    with a ``_target_`` are built first, ``overrides`` win over the node."""
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}
    kwargs = {k: instantiate(v) for k, v in cfg.items() if k != "_target_"}
    kwargs.update(overrides)
    return resolve_target(cfg["_target_"])(**kwargs)
