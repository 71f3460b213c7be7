"""The file formats of the real-data loaders, read without PIL or PyYAML.

`read_png(path, mode=None)` returns what ``np.asarray(Image.open(path))``
returns (``.convert("RGB")`` first where ``mode="RGB"``) for the PNGs that
LineMOD and YCB-Video hold: colour types 0 (grey), 2 (RGB), 3 (palette),
4 (grey + alpha) and 6 (RGBA) at 8 bits, and 16-bit big-endian samples
of grey (the depth images, as uint16), RGB and RGBA (their high bytes, as
PIL keeps them). A palette image reads as its indices, and
as the palette's colours under ``"RGB"``; ``"RGB"`` drops alpha and
repeats grey. The chunks are walked here, the image data inflated by
stdlib ``zlib`` and the row filters undone by the native data plane
(``native.png_unfilter``: Average and Paeth read the pixel just rebuilt,
which NumPy cannot vectorise). Interlaced (Adam7) files, bit depths below
8, 16-bit grey + alpha and 16-bit images under ``"RGB"`` raise ValueError
naming the file, so that no file is misread quietly.

`write_png(path, arr, filters)` writes those PNGs (every row filter, by
row), for test layouts and predicted masks.

`read_yaml(path)` / `parse_yaml(text)` read the YAML subset of upstream's
``gt.yml``, ``info.yml`` and ``models_info.yml`` and of what
``yaml.safe_dump`` writes, resolving scalars as PyYAML's ``safe_load``
does (YAML 1.1: octal ints with a leading 0, ``0x`` and ``0b`` ints,
``yes`` / ``no`` booleans, ``~`` nulls): block mappings and sequences (a sequence may sit
at its key's indent), flow sequences and mappings (which may span lines),
plain, single- and double-quoted scalars, comments and one leading
``---``. Anchors, aliases, tags, block scalars, complex keys, directives,
timestamps, sexagesimal numbers and several documents raise ValueError.

`dump_yaml(obj)` / `write_yaml(path, obj)` write what ``yaml.safe_dump(obj,
sort_keys=False)`` writes for nested mappings whose leaves are ints,
floats, booleans, None, strings and lists or tuples of those (block
style, a sequence at its key's indent, empty ones as ``[]`` / ``{}``; a
container inside a sequence raises TypeError), so that `read_yaml` and
PyYAML read back the same values: floats with a dot in the mantissa and a signed
exponent (``1.0e-05``, ``.inf``, ``.nan``), ``true`` / ``false`` /
``null``, and a string quoted wherever YAML 1.1 would resolve it plain to
something else (``''``, ``'1.0'``, ``'yes'``, ``'null'``).
"""

from __future__ import annotations

import json
import math
import re
import struct
import zlib
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np

# ---------------- PNG ----------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel, by colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_png(path, mode: Optional[str] = None) -> np.ndarray:
    """The pixels of the PNG at `path`: (H, W) for grey and palette
    indices, (H, W, C) otherwise; uint8, or uint16 for 16-bit grey.
    `mode="RGB"` gives (H, W, 3) uint8."""
    from plr2_tpu_torch import native

    if mode not in (None, "RGB"):
        raise ValueError(f"read_png: mode {mode!r} (None or 'RGB')")
    what = f"PNG {str(path)!r}"
    data = Path(path).read_bytes()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{what}: no IHDR or no IDAT chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{what}: interlaced (Adam7) PNGs are not read")
    if ctype not in _CHANNELS:
        raise ValueError(f"{what}: colour type {ctype} (not 0, 2, 3, 4, 6)")
    if depth not in (8, 16) or (ctype in (3, 4) and depth != 8):
        raise ValueError(f"{what}: bit depth {depth} (only 8, and 16 for "
                         "grey, RGB and RGBA)")
    channels, size = _CHANNELS[ctype], depth // 8
    if size == 2 and mode == "RGB":
        raise ValueError(f"{what}: 16-bit images under 'RGB' are not read")
    rows = native.png_unfilter(zlib.decompress(b"".join(idat)), height,
                               width * channels * size, channels * size, what)
    if size == 2:
        px = rows.reshape(-1).view(">u2").astype(np.uint16)
        if ctype != 0:
            px = (px >> 8).astype(np.uint8)  # PIL keeps the high byte
    else:
        px = rows.reshape(-1)
    px = px.reshape((height, width, channels) if channels > 1 else (height, width))
    if mode is None:
        return px
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{what}: palette image without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)  # PIL pads the palette with black
        full[:len(palette)] = palette
        return full[px]
    if ctype in (0, 4):
        grey = px if ctype == 0 else px[..., 0]
        return np.repeat(grey[..., None], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _predict(kind: int, left: np.ndarray, up: np.ndarray,
             upleft: np.ndarray) -> np.ndarray:
    """The PNG filter `kind`'s prediction of each byte (int arrays)."""
    if kind == 0:
        return np.zeros_like(left)
    if kind == 1:
        return left
    if kind == 2:
        return up
    if kind == 3:
        return (left + up) >> 1
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    return np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))


def write_png(path, arr: np.ndarray, filters=(0, 1, 2, 3, 4),
              palette: Optional[np.ndarray] = None, level: int = 6) -> None:
    """Write `arr` as a PNG: (H, W) grey, (H, W, 2) grey + alpha, (H, W, 3)
    RGB or (H, W, 4) RGBA; uint8 at 8 bits, uint16 at 16. With `palette`
    ((N, 3) uint8), `arr` (H, W) uint8 holds the indices. Row r is filtered
    with `filters[r % len(filters)]` (0-4: None, Sub, Up, Average, Paeth)."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16) or arr.ndim not in (2, 3):
        raise ValueError(f"write_png: (H, W[, C]) uint8 or uint16, got "
                         f"{arr.shape} {arr.dtype}")
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    if ctype == 3 and (arr.dtype != np.uint8 or channels != 1):
        raise ValueError("write_png: palette indices must be (H, W) uint8")
    size = arr.dtype.itemsize
    h, w = arr.shape[:2]
    rows = arr.astype(f">u{size}").view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = channels * size
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    out = np.empty((h, rows.shape[1] + 1), np.uint8)
    for r in range(h):
        kind = int(filters[r % len(filters)])
        out[r, 0] = kind
        out[r, 1:] = (rows[r] - _predict(kind, left[r], up[r], upleft[r])) & 0xFF

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    blob = PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8 * size, ctype, 0, 0, 0))
    if palette is not None:
        blob += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    blob += chunk(b"IDAT", zlib.compress(out.tobytes(), level)) + chunk(b"IEND", b"")
    Path(path).write_bytes(blob)


# ---------------- YAML ----------------

_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL_RE = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP_RE = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                            "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False",
                                  "FALSE", "off", "Off", "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")


class _YamlError(ValueError):
    pass


def _resolve_plain(s: str) -> Any:
    """A plain scalar as PyYAML's safe_load resolves it."""
    if s in _NULLS:
        return None
    if s in _BOOLS:
        return _BOOLS[s]
    if _INT_RE.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    if _SEXAGESIMAL_RE.match(s) or _TIMESTAMP_RE.match(s):
        raise _YamlError(f"scalar {s!r}: sexagesimal numbers and timestamps "
                         "are not read")
    if s[0] in "&*!|>%@`":
        raise _YamlError(f"{s!r}: anchors, aliases, tags, block scalars and "
                         "reserved indicators are not read")
    return s


def _quoted(s: str) -> Tuple[str, int]:
    """The quoted scalar at the start of `s` and the length it took."""
    q = s[0]
    i = 1
    while i < len(s):
        if q == "'" and s[i] == "'":
            if s[i + 1:i + 2] == "'":
                i += 2
                continue
            return s[1:i].replace("''", "'"), i + 1
        if q == '"':
            if s[i] == "\\":
                i += 2
                continue
            if s[i] == '"':
                try:
                    return json.loads(s[:i + 1]), i + 1
                except json.JSONDecodeError as e:
                    raise _YamlError(f"double-quoted scalar {s[:i + 1]!r}: "
                                     f"escape not read ({e})") from None
        i += 1
    raise _YamlError(f"unterminated quoted scalar {s!r}")


def _scalar(s: str) -> Any:
    s = s.strip()
    if s[:1] in ("'", '"'):
        v, n = _quoted(s)
        if s[n:].strip():
            raise _YamlError(f"text after a quoted scalar: {s!r}")
        return v
    return _resolve_plain(s)


def _flow(s: str, i: int) -> Tuple[Any, int]:
    """The flow node at s[i:] ([...], {...} or a scalar) and the index after
    it."""
    while s[i] == " ":
        i += 1
    if s[i] in "[{":
        close = "]" if s[i] == "[" else "}"
        is_map = s[i] == "{"
        out: Any = {} if is_map else []
        i += 1
        while True:
            while s[i] == " ":
                i += 1
            if s[i] == close:
                return out, i + 1
            if is_map:
                key, i = _flow_scalar(s, i, key=True)
                while s[i] == " ":
                    i += 1
                if s[i] == ":":
                    val, i = _flow(s, i + 1)
                else:
                    val = None
                out[key] = val
            else:
                val, i = _flow(s, i)
                out.append(val)
            while s[i] == " ":
                i += 1
            if s[i] == ",":
                i += 1
            elif s[i] != close:
                raise _YamlError(f"flow collection {s!r}: expected ',' or "
                                 f"{close!r} at {i}")
    return _flow_scalar(s, i)


def _flow_scalar(s: str, i: int, key: bool = False) -> Tuple[Any, int]:
    if s[i] in "'\"":
        v, n = _quoted(s[i:])
        return v, i + n
    j = i
    while j < len(s) and s[j] not in ",]}" and not (
            key and s[j] == ":" and s[j + 1:j + 2] in (" ", ",", "}", "")):
        if s[j] in "[{":
            raise _YamlError(f"flow collection {s!r}: nested bracket in a scalar")
        j += 1
    return _resolve_plain(s[i:j].strip()), j


def _flow_value(text: str) -> Any:
    val, n = _flow(text + " ", 0)
    if text[n:].strip():
        raise _YamlError(f"text after a flow collection: {text!r}")
    return val


def _strip_comment(line: str) -> str:
    """`line` without a trailing comment (a '#' at the start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(content: str) -> Optional[Tuple[Any, str]]:
    """(key, rest) where `content` is a mapping entry "key: rest" or
    "key:", else None."""
    if content[:1] in ("'", '"'):
        key, n = _quoted(content)
        rest = content[n:]
        if rest.startswith(":") and rest[1:2] in ("", " "):
            return key, rest[1:].strip()
        return None
    if content[:1] in "[{":
        return None
    m = re.search(r":(?: |$)", content)
    if m is None:
        return None
    return _resolve_plain(content[:m.start()].strip()), content[m.end():].strip()


class _Lines:
    def __init__(self, text: str):
        self.items: List[Tuple[int, str]] = []
        started = False
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise _YamlError("tab in indentation")
            line = _strip_comment(raw)
            content = line.strip()
            if not content:
                continue
            if content.startswith("%"):
                raise _YamlError(f"directive {content!r} is not read")
            if content in ("---", "...") or content.startswith("--- "):
                if started or content != "---":
                    raise _YamlError("several documents, or a node on the "
                                     "'---' line, are not read")
                continue
            started = True
            self.items.append((len(line) - len(line.lstrip(" ")), content))

    def flow_text(self, i: int, first: str) -> Tuple[str, int]:
        """A flow collection that starts with `first` (line i) and may
        continue on later lines -> its text and the next line."""
        text = first
        while _open_brackets(text) > 0:
            i += 1
            if i >= len(self.items):
                raise _YamlError(f"unterminated flow collection {first!r}")
            text += " " + self.items[i][1]
        return text, i + 1


def _open_brackets(text: str) -> int:
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _value(lines: _Lines, i: int, rest: str, parent_indent: int,
           seq_at_parent: bool) -> Tuple[Any, int]:
    """The value of an entry whose inline text is `rest` (line i), and the
    next line: inline (scalar or flow), or the block below it."""
    if rest:
        if rest[0] in "[{":
            text, nxt = lines.flow_text(i, rest)
            return _flow_value(text), nxt
        if rest[0] in "&*!|>":
            raise _YamlError(f"{rest!r}: anchors, aliases, tags and block "
                             "scalars are not read")
        return _scalar(rest), i + 1
    nxt = i + 1
    if nxt < len(lines.items):
        ind, content = lines.items[nxt]
        if ind > parent_indent or (seq_at_parent and ind == parent_indent
                                   and (content == "-" or content.startswith("- "))):
            return _node(lines, nxt, ind)
    return None, nxt


def _node(lines: _Lines, i: int, indent: int) -> Tuple[Any, int]:
    ind, content = lines.items[i]
    if content == "-" or content.startswith("- "):
        out = []
        while i < len(lines.items):
            ind, content = lines.items[i]
            if ind != indent or not (content == "-" or content.startswith("- ")):
                break
            rest = content[1:].lstrip(" ")
            if rest.startswith("- ") or rest == "-" or (
                    rest and rest[0] not in "[{" and _split_key(rest) is not None):
                # a nested mapping or sequence that starts on the dash line:
                # read it as a block at the column after the dash
                col = ind + len(content) - len(rest)
                lines.items[i] = (col, rest)
                val, i = _node(lines, i, col)
            else:
                val, i = _value(lines, i, rest, ind, seq_at_parent=False)
            out.append(val)
        return out, i
    if content.startswith("? "):
        raise _YamlError("complex mapping keys are not read")
    entry = _split_key(content)
    if entry is None:
        if content[0] in "[{":
            text, nxt = lines.flow_text(i, content)
            return _flow_value(text), nxt
        return _scalar(content), i + 1
    out = {}
    while i < len(lines.items):
        ind, content = lines.items[i]
        if ind != indent:
            if ind > indent:
                raise _YamlError(f"unexpected indent at {content!r}")
            break
        entry = _split_key(content)
        if entry is None:
            raise _YamlError(f"expected a mapping entry, got {content!r}")
        key, rest = entry
        val, i = _value(lines, i, rest, ind, seq_at_parent=True)
        out[key] = val
    return out, i


def parse_yaml(text: str) -> Any:
    """One YAML document of the subset in the module docstring."""
    lines = _Lines(text)
    if not lines.items:
        return None
    try:
        val, i = _node(lines, 0, lines.items[0][0])
    except IndexError:
        raise _YamlError("unterminated flow collection or quoted scalar") from None
    if i != len(lines.items):
        raise _YamlError(f"unexpected text at {lines.items[i][1]!r}")
    return val


def read_yaml(path) -> Any:
    try:
        return parse_yaml(Path(path).read_text())
    except _YamlError as e:
        raise ValueError(f"YAML {str(path)!r}: {e}") from None


# a string written plain only when it has none of YAML's indicators and
# resolves back to itself (`_plain_ok`)
_PLAIN_SAFE_RE = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./+ -]*$")


def _plain_ok(s: str) -> bool:
    if not _PLAIN_SAFE_RE.match(s) or s.endswith(" ") or "  " in s:
        return False
    try:
        return _resolve_plain(s) == s
    except _YamlError:
        return False


def _dump_scalar(v: Any) -> str:
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
        if "e" in r:  # YAML 1.1 floats need a dot and a signed exponent
            mant, exp = r.split("e")
            return f"{mant if '.' in mant else mant + '.0'}e{exp}"
        return r
    if isinstance(v, str):
        if _plain_ok(v):
            return v
        if v.isprintable() and v.isascii():
            return "'" + v.replace("'", "''") + "'"
        return json.dumps(v)
    raise TypeError(f"YAML: cannot write {type(v).__name__} {v!r}")


def _dump_node(obj: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = _dump_scalar(k)
            if isinstance(v, (dict, list, tuple)) and len(v):
                out.append(f"{pad}{key}:")
                # a sequence sits at its key's indent, as PyYAML writes it
                _dump_node(v, indent + 2 if isinstance(v, dict) else indent, out)
            else:
                out.append(f"{pad}{key}: {_dump_value(v)}")
        return
    out.extend(f"{pad}- {_dump_scalar(v)}" for v in obj)


def _dump_value(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)


def dump_yaml(obj: Any) -> str:
    """`obj` as the YAML text of the module docstring's writer."""
    if isinstance(obj, (dict, list, tuple)) and len(obj):
        out: List[str] = []
        _dump_node(obj, 0, out)
        return "\n".join(out) + "\n"
    return _dump_value(obj) + "\n"


def write_yaml(path, obj: Any) -> None:
    Path(path).write_text(dump_yaml(obj))
