"""Config loading and ``_target_`` instantiation for the port.

``load_yaml`` reads the repo's YAML configs with a small stdlib reader
(``parse_yaml``) that gives PyYAML's ``safe_load`` results (YAML 1.1) for the
subset those files use, so the entry points run where PyYAML is missing.

``_target_`` paths of the JAX package (``dxmi_tpu.*``) and of the reference
(``models.DxMI.*``) resolve through an alias table to the port's classes,
so the repo's configs and reference run directories build port modules.
"""
from __future__ import annotations

import importlib
import re
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
