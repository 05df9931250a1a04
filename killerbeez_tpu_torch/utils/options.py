"""JSON option-string parsing — the PARSE_OPTION_* macro family.

Every pluggable component in the reference takes a JSON option string
(``-d/-i/-m``) parsed by PARSE_OPTION_{STRING,INT,DOUBLE,ARRAY,
INT_ARRAY} macros into its state struct (SURVEY §5, e.g. reference
file_driver.c:44-50, afl_instrumentation.c:359-371). Here a component
declares an option schema and gets a validated dict back.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Optional, Sequence


class OptionError(ValueError):
    pass


def parse_options(options: Optional[str],
                  schema: Optional[Mapping[str, type]] = None,
                  defaults: Optional[Mapping[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Parse a JSON option string against a schema.

    ``schema`` maps option name -> expected type (int, float, str, bool,
    list). Unknown keys are rejected when a schema is given (the
    reference silently ignores them, but strictness catches typos —
    the help text tells the user the valid set). ``defaults`` seeds the
    result.
    """
    result: Dict[str, Any] = dict(defaults or {})
    if options is None or options == "":
        return result
    if isinstance(options, str):
        try:
            opts = json.loads(options)
        except json.JSONDecodeError as e:
            raise OptionError(f"invalid JSON options: {e}") from e
    else:
        opts = dict(options)
    if not isinstance(opts, dict):
        raise OptionError("options must be a JSON object")
    for key, value in opts.items():
        if schema is not None:
            if key not in schema:
                raise OptionError(
                    f"unknown option {key!r}; valid: {sorted(schema)}")
            want = schema[key]
            if want in (int, float) and isinstance(value, bool):
                raise OptionError(f"option {key!r} must be {want.__name__}")
            if want is float and isinstance(value, int):
                value = float(value)
            if not isinstance(value, want):
                raise OptionError(
                    f"option {key!r} must be {want.__name__}, "
                    f"got {type(value).__name__}")
        result[key] = value
    return result


def get_option(opts: Mapping[str, Any], name: str, default: Any = None) -> Any:
    return opts.get(name, default)


def add_option_to_json(options: Optional[str], name: str,
                       value: Any) -> str:
    """Return a new option string with ``name`` set (reference
    add_int_option_to_json generalized)."""
    opts = json.loads(options) if options else {}
    opts[name] = value
    return json.dumps(opts)


def add_int_option_to_json(options: Optional[str], name: str,
                           value: int) -> str:
    return add_option_to_json(options, name, int(value))


def format_help(component: str, schema: Mapping[str, type],
                descriptions: Mapping[str, str]) -> str:
    """Self-describing per-module help aggregated by factories
    (reference driver_factory.c:146-158)."""
    lines = [f"{component} options (JSON):"]
    for key in sorted(schema):
        t = schema[key].__name__
        lines.append(f"  {key} ({t}): {descriptions.get(key, '')}")
    return "\n".join(lines) + "\n"
