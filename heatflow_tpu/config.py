"""Simulation configuration handling.

The YAML schema is compatible with the reference framework's configs
(``cfgs/*.yaml`` in cebarker1000/heatflow):

.. code-block:: yaml

    mats:
      <name>: {rho: float, cv: float, k: float, r: float, z: float, mesh: float}
    heating:
      file: path/to/heating.csv     # columns: time, temp [, oside]
      fwhm: float                   # laser FWHM [m]
      ic_temp: float                # initial / far-field temperature [K]
    timing:
      t_final: float                # total simulated time [s]
      num_steps: int
    io:
      mesh_path: str                # vestigial in the reference; kept for parity
    material_tags: {}               # populated into mesh_cfg.yaml copies

(ref schema usage: run_no_diamond.py:62-76,204-224,256-262)
"""

from __future__ import annotations

import copy
import math
import os
import re
from typing import Any

REQUIRED_MAT_KEYS = ("rho", "cv", "k", "r", "z", "mesh")


class ConfigError(ValueError):
    """Raised when a configuration file is malformed."""


# --------------------------------------------------------------------------
# A reader and writer for the block-YAML subset the schema uses: nested
# mappings, scalars, empty ``{}`` / ``[]``, and flat lists (block ``- x``
# items or a flow ``[a, b]`` of scalars). Plain scalars resolve as PyYAML's
# YAML 1.1 safe loader resolves them (so ``20e-6`` — no dot — stays a
# string, as it does there). Anything else (anchors, aliases, tags, block
# scalars, flow mappings, nested lists, octal/hex/sexagesimal numbers)
# raises ConfigError instead of being guessed at.
# --------------------------------------------------------------------------

_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# plain scalars PyYAML 1.1 would read as a number in a form this subset
# does not take (octal, hex, binary, underscores, sexagesimal)
_OTHER_NUMBER = re.compile(
    r"[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[0-9][0-9_]*(?::[0-5]?[0-9])+"
    r"(?:\.[0-9_]*)?|[0-9][0-9_]*_[0-9_]*(?:\.[0-9_]*)?(?:[eE][-+][0-9]+)?"
    r"|\.?[0-9][0-9_]*\.[0-9_]*_[0-9_]*(?:[eE][-+][0-9]+)?)")
_KEY = re.compile(r"([^\s'\"#][^:#]*?|'(?:[^']|'')*'|\"[^\"\\]*\")"
                  r"\s*:(?:\s+(.*))?$")


def _plain(text: str, where: str):
    """Resolve a plain (unquoted) scalar the way PyYAML's safe loader
    does, for the forms this subset takes."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _INF.fullmatch(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _OTHER_NUMBER.fullmatch(text):
        raise ConfigError(f"{where}: number form {text!r} is not supported")
    if text[0] in "&*!|>%@`{[]}," or text.startswith(("- ", "? ", ": ")):
        raise ConfigError(f"{where}: unsupported YAML construct {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """Drop a trailing `` #`` comment that is outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :[,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str, where: str):
    text = text.strip()
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'"):
            raise ConfigError(f"{where}: unterminated quoted scalar")
        body = text[1:-1]
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise ConfigError(f"{where}: malformed single-quoted scalar")
        return body.replace("''", "'")
    if text.startswith('"'):
        if len(text) < 2 or not text.endswith('"') or "\\" in text:
            raise ConfigError(f"{where}: unsupported double-quoted scalar")
        return text[1:-1]
    if text == "{}":
        return {}
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = [t.strip() for t in inner.split(",")]
        if any(not t or t[0] in "[{" for t in items):
            raise ConfigError(f"{where}: only flat lists of scalars")
        return [_scalar(t, where) for t in items]
    return _plain(text, where)


def parse_yaml(text: str, source: str = "<string>"):
    """Parse a document of the block-YAML subset described above."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ConfigError(f"{source}:{n}: tab indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            if lines:
                raise ConfigError(f"{source}:{n}: multiple documents")
            continue
        lines.append((n, len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][1], source)
    if end != len(lines):
        n = lines[end][0]
        raise ConfigError(f"{source}:{n}: unexpected indentation")
    return value


def _block(lines, i, indent, source):
    """Parse the node whose lines start at ``i`` with this indentation;
    return (value, index of the first line after it)."""
    n, _ind, text = lines[i]
    if text == "-" or text.startswith("- "):
        return _sequence(lines, i, indent, source)
    if _KEY.match(text) is None:
        if len(lines) == 1:
            return _scalar(text, f"{source}:{n}"), 1
        raise ConfigError(f"{source}:{n}: expected 'key: value'")
    out = {}
    while i < len(lines) and lines[i][1] == indent:
        n, _ind, text = lines[i]
        where = f"{source}:{n}"
        m = _KEY.match(text)
        if m is None:
            raise ConfigError(f"{where}: expected 'key: value'")
        key = _scalar(m.group(1), where)
        if key in out:
            raise ConfigError(f"{where}: duplicate key {key!r}")
        rest = m.group(2)
        i += 1
        if rest is not None and rest.strip():
            if rest.strip()[0] in "|>":
                raise ConfigError(f"{where}: block scalars are not "
                                  "supported")
            out[key] = _scalar(rest, where)
        elif i < len(lines) and (lines[i][1] > indent or (
                lines[i][1] == indent and (lines[i][2] == "-"
                                           or lines[i][2].startswith("- ")))):
            out[key], i = _block(lines, i, lines[i][1], source)
        else:
            out[key] = None
    if i < len(lines) and lines[i][1] > indent:
        raise ConfigError(f"{source}:{lines[i][0]}: unexpected indentation")
    return out, i


def _sequence(lines, i, indent, source):
    out = []
    while i < len(lines) and lines[i][1] == indent and (
            lines[i][2] == "-" or lines[i][2].startswith("- ")):
        n, _ind, text = lines[i]
        item = text[1:].strip()
        if not item or item.startswith("- ") or _KEY.match(item):
            raise ConfigError(f"{source}:{n}: only flat lists of scalars")
        out.append(_scalar(item, f"{source}:{n}"))
        i += 1
    return out, i


def load_yaml(path: str | os.PathLike):
    """Read a YAML file of the subset :func:`parse_yaml` takes."""
    with open(path, "r") as f:
        return parse_yaml(f.read(), str(path))


def _emit_scalar(v) -> str:
    if hasattr(v, "item") and not isinstance(v, (list, dict, str)):
        v = v.item()                  # numpy scalar → Python scalar
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
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if not v.isprintable():
            raise ConfigError(f"cannot write string {v!r}")
        if (re.fullmatch(r"[A-Za-z0-9_./+][A-Za-z0-9_./+@ -]*", v)
                and not v.endswith(" ") and " #" not in v):
            try:
                plain_ok = _plain(v, "") == v
            except ConfigError:
                plain_ok = False
            if plain_ok:
                return v
        return "'" + v.replace("'", "''") + "'"
    raise ConfigError(f"cannot write value of type {type(v).__name__}")


def _emit(obj, indent: int, out: list) -> None:
    pad = " " * indent
    for key in sorted(obj):
        v = obj[key]
        k = _emit_scalar(key)
        if isinstance(v, dict) and v:
            out.append(f"{pad}{k}:")
            _emit(v, indent + 2, out)
        elif isinstance(v, (list, tuple)) and len(v):
            out.append(f"{pad}{k}:")
            for item in v:
                if isinstance(item, (dict, list, tuple)):
                    raise ConfigError(f"{k}: only flat lists can be written")
                out.append(f"{pad}- {_emit_scalar(item)}")
        elif isinstance(v, dict):
            out.append(f"{pad}{k}: {{}}")
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{k}: []")
        else:
            out.append(f"{pad}{k}: {_emit_scalar(v)}")


def dump_yaml(cfg: dict) -> str:
    """Write a mapping in block style with sorted keys — the same text
    ``yaml.safe_dump(cfg, default_flow_style=False)`` gives for configs of
    this schema."""
    if not isinstance(cfg, dict):
        raise ConfigError("top level must be a mapping")
    if not cfg:
        return "{}\n"
    out: list = []
    _emit(cfg, 0, out)
    return "\n".join(out) + "\n"


def load_config(path: str | os.PathLike) -> dict:
    """Load a YAML simulation config, returning a plain dict (reference-compatible)."""
    cfg = load_yaml(path)
    if not isinstance(cfg, dict):
        raise ConfigError(f"{path}: top level must be a mapping")
    return cfg


def save_config(cfg: dict, path: str | os.PathLike) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    text = dump_yaml(cfg)
    with open(path, "w") as f:
        f.write(text)


def mat_float(cfg: dict, mat: str, key: str) -> float:
    """Fetch ``cfg['mats'][mat][key]`` as float with a helpful error."""
    try:
        return float(cfg["mats"][mat][key])
    except KeyError as e:
        raise ConfigError(f"config missing mats.{mat}.{key}") from e
    except (TypeError, ValueError) as e:
        raise ConfigError(f"config mats.{mat}.{key} is not a number: "
                          f"{cfg['mats'][mat].get(key)!r}") from e


def validate_config(cfg: dict, *, require_heating_file: bool = False) -> None:
    """Validate the schema pieces every driver needs.

    The reference validates lazily (crashes at float() time); we check up
    front but accept the same schema.
    """
    if "mats" not in cfg or not isinstance(cfg["mats"], dict) or not cfg["mats"]:
        raise ConfigError("config must define a non-empty 'mats' mapping")
    for name, mat in cfg["mats"].items():
        if not isinstance(mat, dict):
            raise ConfigError(f"mats.{name} must be a mapping")
        # explicit-bounds (custom layout) materials carry their geometry in
        # 'bounds' instead of the stack parameters r/z (geometry.layout_custom)
        required = (("rho", "cv", "k", "mesh") if "bounds" in mat
                    else REQUIRED_MAT_KEYS)
        if "bounds" in mat:
            if (not isinstance(mat["bounds"], (list, tuple))
                    or len(mat["bounds"]) != 4):
                raise ConfigError(
                    f"mats.{name}.bounds must be [zmin, zmax, rmin, rmax]")
        for k in required:
            if k not in mat:
                raise ConfigError(f"mats.{name} missing key '{k}'")
            try:
                float(mat[k])
            except (TypeError, ValueError):
                raise ConfigError(
                    f"mats.{name}.{k} is not a number: {mat[k]!r}")
    for section, keys in (("heating", ("fwhm", "ic_temp")),
                          ("timing", ("t_final", "num_steps"))):
        if section not in cfg:
            raise ConfigError(f"config missing '{section}' section")
        for k in keys:
            if k not in cfg[section]:
                raise ConfigError(f"config missing {section}.{k}")
    if require_heating_file and "file" not in cfg["heating"]:
        raise ConfigError("config missing heating.file")


def with_parameters(cfg: dict, *, fwhm: float | None = None,
                    sample_k: float | None = None,
                    sample_z: float | None = None) -> dict:
    """Return a deep copy of ``cfg`` with sweep parameters substituted.

    Mirrors the reference sweep's config mutation
    (ref: parameter_sweep.py:238-266) but never mutates the input.
    """
    out = copy.deepcopy(cfg)
    if fwhm is not None:
        out["heating"]["fwhm"] = float(fwhm)
    if sample_k is not None:
        out["mats"]["p_sample"]["k"] = float(sample_k)
    if sample_z is not None:
        out["mats"]["p_sample"]["z"] = float(sample_z)
    return out


def timing(cfg: dict) -> tuple[float, int, float]:
    """Return (t_final, num_steps, dt)."""
    t_final = float(cfg["timing"]["t_final"])
    num_steps = int(cfg["timing"]["num_steps"])
    return t_final, num_steps, t_final / num_steps


def config_equal(a: Any, b: Any) -> bool:
    """Structural equality useful for mesh-reuse decisions."""
    return dump_yaml(a) == dump_yaml(b)
