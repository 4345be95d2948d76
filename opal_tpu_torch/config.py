"""Input-file handling.

YAML configuration with math-expression values, mirroring the reference
API surface ``Config::{from_file, with_context, contains, read, func,
func2, func3}`` (reference: ``src/setup.rs:84-284``) while evaluating
through the numpy expression DSL in :mod:`opal_tpu_torch.expression`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import yaml

from .expression import Expression, ExpressionError, build_context


class ConfigError(ValueError):
    """Error locating or converting an input value.

    Mirrors the reference's ConfigError kinds
    (``src/setup.rs:35-76``).
    """

    def __init__(self, kind: str, section: str = "", field: str = ""):
        self.kind = kind
        self.section = section
        self.field = field
        msgs = {
            "missing-file": "Unable to open configuration file.",
            "missing-section": f'Could not find section "{section}".',
            "missing-field": f'Could not find field "{field}" in section "{section}".',
            "conversion-failure": (
                f'Could not convert field "{field}" in section "{section}" '
                "to target type."
            ),
        }
        super().__init__(msgs.get(kind, kind))


class Config:
    """Parsed input configuration.

    ``with_context(section)`` loads the base physics constants plus the
    user's constants block into the expression-evaluation context
    (reference: ``src/setup.rs:110-179``).
    """

    def __init__(self, data: dict):
        if not isinstance(data, dict):
            raise ConfigError("missing-file")
        self.data = data
        self.ctx = build_context(None)

    @classmethod
    def from_file(cls, path: str | Path) -> "Config":
        try:
            text = Path(path).read_text()
        except OSError as exc:
            raise ConfigError("missing-file") from exc
        return cls.from_string(text)

    @classmethod
    def from_string(cls, text: str) -> "Config":
        try:
            data = yaml.safe_load(text)
        except yaml.YAMLError as exc:
            raise ConfigError("missing-file") from exc
        return cls(data)

    def with_context(self, section: str) -> "Config":
        block = self.data.get(section)
        self.ctx = build_context(block if isinstance(block, dict) else None)
        return self

    def contains(self, section: str) -> bool:
        return section in self.data and self.data[section] is not None

    def _raw(self, section: str, field: str):
        if not self.contains(section):
            raise ConfigError("missing-section", section, field)
        sec = self.data[section]
        if not isinstance(sec, dict) or field not in sec or sec[field] is None:
            raise ConfigError("missing-field", section, field)
        return sec[field]

    # -- typed readers (reference: setup.rs:287-370) ---------------------

    def read_f64(self, section: str, field: str) -> float:
        raw = self._raw(section, field)
        if isinstance(raw, bool):
            raise ConfigError("conversion-failure", section, field)
        if isinstance(raw, (int, float)):
            return float(raw)
        if isinstance(raw, str):
            try:
                return float(Expression(raw, self.ctx, ())())
            except ExpressionError as exc:
                raise ConfigError("conversion-failure", section, field) from exc
        raise ConfigError("conversion-failure", section, field)

    def read_int(self, section: str, field: str) -> int:
        raw = self._raw(section, field)
        if isinstance(raw, bool) or not isinstance(raw, int):
            raise ConfigError("conversion-failure", section, field)
        return raw

    def read_usize(self, section: str, field: str) -> int:
        value = self.read_int(section, field)
        if value < 0:
            raise ConfigError("conversion-failure", section, field)
        return value

    def read_bool(self, section: str, field: str) -> bool:
        raw = self._raw(section, field)
        if not isinstance(raw, bool):
            raise ConfigError("conversion-failure", section, field)
        return raw

    def read_string(self, section: str, field: str) -> str:
        raw = self._raw(section, field)
        if not isinstance(raw, str):
            raise ConfigError("conversion-failure", section, field)
        return raw

    def read_strings(self, section: str, field: str) -> list[str]:
        """A single string becomes a one-element list (setup.rs:334-360)."""
        raw = self._raw(section, field)
        if isinstance(raw, str):
            return [raw]
        if isinstance(raw, list):
            got = [s for s in raw if isinstance(s, str)]
            if not got:
                raise ConfigError("conversion-failure", section, field)
            return got
        raise ConfigError("conversion-failure", section, field)

    def read_opt_f64(self, section: str, field: str) -> float | None:
        try:
            return self.read_f64(section, field)
        except ConfigError:
            return None

    def read_bool_default(self, section: str, field: str, default: bool) -> bool:
        try:
            return self.read_bool(section, field)
        except ConfigError:
            return default

    # -- function readers (reference: setup.rs:207-284) ------------------

    def func(self, section: str, field: str, arg: str) -> Callable:
        return self._func(section, field, (arg,))

    def func2(self, section: str, field: str, args: tuple[str, str]) -> Callable:
        return self._func(section, field, tuple(args))

    def func3(self, section: str, field: str, args: tuple[str, str, str]) -> Callable:
        return self._func(section, field, tuple(args))

    def _func(self, section: str, field: str, args: tuple[str, ...]) -> Callable:
        raw = self._raw(section, field)
        if isinstance(raw, (int, float)) and not isinstance(raw, bool):
            raw = repr(float(raw))
        if not isinstance(raw, str):
            raise ConfigError("conversion-failure", section, field)
        try:
            return Expression(raw, self.ctx, args)
        except ExpressionError as exc:
            raise ConfigError("conversion-failure", section, field) from exc
