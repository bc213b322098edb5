"""Config loading (counterpart of ``gligen_tpu/config.py``): the
reference's YAML configs without OmegaConf and without PyYAML.

``configs/*.yaml`` use a small part of YAML, and the machine with the card
has no PyYAML, so ``parse_yaml`` reads exactly that part: block mappings
and lists by indentation, one-line flow maps ``{...}`` and flow lists
``[...]``, anchors ``&name`` and aliases ``*name``, comments, plain and
quoted scalars.  A plain scalar resolves as ``yaml.safe_load`` resolves it
(null, the YAML 1.1 booleans, decimal ints, floats with a point), except
that an exponent without a point (``1e-4``) is a float here, where PyYAML
keeps the string.  Anything else (block scalars ``|``/``>``, tags,
documents, multi-line flows, an octal-looking int) raises ``ValueError``
naming the line.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_OCTAL = re.compile(r"[-+]?0[0-9_]+$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+]?[0-9]+)?$"
                    r"|[-+]?[0-9][0-9_]*[eE][-+]?[0-9]+$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
                  "+.inf": float("inf"), "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}


class _Line:
    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text

    def error(self, what: str) -> ValueError:
        return ValueError(f"YAML line {self.number}: {what}: {self.text!r}")


def _strip_comment(text: str) -> str:
    """``text`` up to a ``#`` that starts a comment: at the start or after
    a space, and outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(token: str, line: _Line) -> Any:
    """A plain or quoted scalar token -> its Python value."""
    if token[:1] == "'":
        if len(token) < 2 or token[-1] != "'":
            raise line.error("unterminated quote")
        return token[1:-1].replace("''", "'")
    if token[:1] == '"':
        if len(token) < 2 or token[-1] != '"':
            raise line.error("unterminated quote")
        body = token[1:-1]
        if "\\" in body:
            body = body.encode("latin-1", "backslashreplace").decode("unicode_escape")
        return body
    if token[:1] in ("|", ">", "!", "%", "@", "`") or token.startswith(("---", "...")):
        raise line.error("unsupported YAML")
    if token in _NULL:
        return None
    if token in _TRUE:
        return True
    if token in _FALSE:
        return False
    if _INT.match(token):
        return int(token.replace("_", ""))
    if _OCTAL.match(token):
        raise line.error("an int with a leading zero")
    if _FLOAT.match(token) and any(c.isdigit() for c in token):
        return float(token.replace("_", ""))
    if token in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[token]
    return token


class _Flow:
    """One-line flow collection parser over ``text`` from ``pos``."""

    def __init__(self, text: str, line: _Line, anchors: Dict[str, Any]):
        self.text, self.pos, self.line, self.anchors = text, 0, line, anchors

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self) -> str:
        self._skip()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _expect(self, ch: str):
        if self._peek() != ch:
            raise self.line.error(f"expected {ch!r} in a flow collection")
        self.pos += 1

    def _token(self) -> str:
        self._skip()
        start = self.pos
        if self.pos < len(self.text) and self.text[self.pos] in "'\"":
            quote = self.text[self.pos]
            self.pos += 1
            while self.pos < len(self.text):
                if self.text[self.pos] == quote:
                    if quote == "'" and self.text[self.pos + 1:self.pos + 2] == "'":
                        self.pos += 2
                        continue
                    if quote == '"' and self.text[self.pos - 1] == "\\":
                        self.pos += 1
                        continue
                    break
                self.pos += 1
            self.pos += 1
            return self.text[start:self.pos]
        while self.pos < len(self.text) and self.text[self.pos] not in ",]}":
            if self.text[self.pos] == ":" and self.text[self.pos + 1:self.pos + 2] in (" ", ""):
                break
            self.pos += 1
        return self.text[start:self.pos].strip()

    def value(self) -> Any:
        ch = self._peek()
        if ch == "{":
            self.pos += 1
            out: Dict[Any, Any] = {}
            while self._peek() != "}":
                key = self.value()
                self._expect(":")
                out[key] = None if self._peek() in (",", "}") else self.value()
                if self._peek() == ",":
                    self.pos += 1
            self.pos += 1
            return out
        if ch == "[":
            self.pos += 1
            items: List[Any] = []
            while self._peek() != "]":
                items.append(self.value())
                if self._peek() == ",":
                    self.pos += 1
            self.pos += 1
            return items
        if ch == "":
            raise self.line.error("a flow collection that does not close on its line")
        if ch == "*":
            name = self._token()[1:]
            if name not in self.anchors:
                raise self.line.error(f"unknown alias *{name}")
            return self.anchors[name]
        return _scalar(self._token(), self.line)

    def whole(self) -> Any:
        out = self.value()
        if self._peek():
            raise self.line.error("text after a flow collection")
        return out


class _Parser:
    def __init__(self, text: str):
        self.lines: List[_Line] = []
        for number, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ValueError(f"YAML line {number}: a tab in the indentation")
            body = _strip_comment(raw)
            if body.strip():
                self.lines.append(_Line(number, len(body) - len(body.lstrip()), body.strip()))
        self.i = 0
        self.anchors: Dict[str, Any] = {}

    def parse(self) -> Any:
        if not self.lines:
            return None
        out = self._block(self.lines[0].indent)
        if self.i < len(self.lines):
            raise self.lines[self.i].error("indentation out of place")
        return out

    def _block(self, indent: int) -> Any:
        first = self.lines[self.i]
        if first.indent != indent:
            raise first.error("indentation out of place")
        if first.text == "-" or first.text.startswith("- "):
            return self._sequence(indent)
        return self._mapping(indent)

    def _sequence(self, indent: int) -> List[Any]:
        out = []
        while self.i < len(self.lines) and self.lines[self.i].indent == indent:
            line = self.lines[self.i]
            if not (line.text == "-" or line.text.startswith("- ")):
                raise line.error("a mapping key inside a list")
            self.i += 1
            out.append(self._value(line.text[1:].strip(), line, indent))
        return out

    def _mapping(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while self.i < len(self.lines) and self.lines[self.i].indent == indent:
            line = self.lines[self.i]
            key, sep, rest = self._split_key(line)
            if not sep:
                raise line.error("expected 'key: value'")
            self.i += 1
            out[_scalar(key, line)] = self._value(rest.strip(), line, indent)
        return out

    @staticmethod
    def _split_key(line: _Line) -> Tuple[str, str, str]:
        text = line.text
        if text[:1] in "'\"":
            end = text.find(text[0], 1)
            if end < 0:
                raise line.error("unterminated quote")
            key, rest = text[:end + 1], text[end + 1:]
            return (key, ":", rest[1:]) if rest.startswith(":") else (key, "", rest)
        m = re.search(r":(?:\s|$)", text)
        if not m or text[:1] in "[{-":
            return text, "", ""
        return text[:m.start()].strip(), ":", text[m.end():]

    def _value(self, text: str, line: _Line, indent: int) -> Any:
        """The value after ``key:`` or ``-``: inline, or the block below."""
        anchor = None
        if text.startswith("&"):
            anchor, _, text = text[1:].partition(" ")
            text = text.strip()
        if text:
            if text.startswith("- ") or re.search(r":(?:\s|$)", text) and text[:1] not in "[{'\"":
                raise line.error("a nested collection on one line")
            value = _Flow(text, line, self.anchors).whole()
        elif self.i < len(self.lines) and self.lines[self.i].indent > indent:
            value = self._block(self.lines[self.i].indent)
        elif (self.i < len(self.lines) and self.lines[self.i].indent == indent
              and self.lines[self.i].text.startswith("- ") and not line.text.startswith("-")):
            value = self._sequence(indent)  # a list at its key's indentation
        else:
            value = None
        if anchor is not None:
            self.anchors[anchor] = value
        return value


def parse_yaml(text: str) -> Any:
    """The YAML subset of ``configs/*.yaml`` -> Python objects (an alias is
    the anchored object itself, as PyYAML gives it)."""
    return _Parser(text).parse()


def load_yaml_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_yaml(f.read())


def merge_cli(config: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Shallow merge, CLI overrides win (main.py:66-71)."""
    out = dict(config)
    for k, v in overrides.items():
        if v is not None:
            out[k] = v
    return out


def normalize_model_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill reference defaults and keep the {target, params} shape."""
    out = dict(config)
    model = dict(out.get("model", {}))
    params = dict(model.get("params", {}))
    params.setdefault("fuser_type", "gatedSA")
    model["params"] = params
    out["model"] = model
    out.setdefault("diffusion", {"params": {}})
    return out


@dataclasses.dataclass
class RunOverrides:
    """CLI-overridable run flags, mirroring main.py:16-50."""

    name: Optional[str] = None
    yaml_file: Optional[str] = None
    base_learning_rate: Optional[float] = None
    weight_decay: Optional[float] = None
    warmup_steps: Optional[int] = None
    scheduler_type: Optional[str] = None
    batch_size: Optional[int] = None
    workers: Optional[int] = None
    official_ckpt_name: Optional[str] = None
    ckpt: Optional[str] = None
    inpaint_mode: Optional[bool] = None
    randomize_fg_mask: Optional[bool] = None
    random_add_bg_mask: Optional[bool] = None
    enable_ema: Optional[bool] = None
    ema_rate: Optional[float] = None
    total_iters: Optional[int] = None
    save_every_iters: Optional[int] = None
    disable_inference_in_training: Optional[bool] = None
