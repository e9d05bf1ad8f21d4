"""Request validation without pydantic.

The JAX package validates ``POST /predict`` bodies with a pydantic model
generated from the schema (``list[LoanApplicant]``, extra keys ignored).
The machine with the card has no pydantic, so this module restates the
same lax-mode rules by hand:

- the body is a JSON array of JSON objects;
- keys outside the schema are ignored, missing keys take the schema
  default;
- a categorical value must be a JSON string;
- a numeric value must be a number, a boolean (``true`` -> 1.0) or a
  string that parses as a float (ASCII only, surrounding whitespace
  allowed), as pydantic's lax float parsing accepts.

Errors come back as a list of ``{"type", "loc", "msg", "input"}`` dicts
with pydantic's type names and messages, so a 422 body has the same shape
on both packages.
"""

from __future__ import annotations

import json
from typing import Any

from mlops_tpu_torch.schema.features import SCHEMA

_MSG = {
    "json_invalid": "Invalid JSON",
    "list_type": "Input should be a valid array",
    "model_type": "Input should be an object",
    "string_type": "Input should be a valid string",
    "float_type": "Input should be a valid number",
    "float_parsing": (
        "Input should be a valid number, unable to parse string as a number"
    ),
}


def _error(kind: str, loc: list, value: Any) -> dict[str, Any]:
    return {"type": kind, "loc": loc, "msg": _MSG[kind], "input": value}


def _as_float(value: Any) -> float | None:
    """Lax float coercion, or None when pydantic would refuse the value."""
    if isinstance(value, (bool, int, float)):
        return float(value)
    if isinstance(value, str) and value.isascii():
        try:
            return float(value)
        except ValueError:
            return None
    return None


def validate_records(
    body: bytes | str,
) -> tuple[list[dict[str, Any]] | None, list[dict[str, Any]]]:
    """Parse and validate a request body.

    Returns ``(records, [])`` on success, each record a dict holding every
    schema feature, or ``(None, errors)`` where ``errors`` is the 422
    detail list."""
    try:
        doc = json.loads(body)
    except (ValueError, UnicodeDecodeError) as err:
        return None, [_error("json_invalid", [], str(err))]
    if not isinstance(doc, list):
        return None, [_error("list_type", [], doc)]
    records: list[dict[str, Any]] = []
    errors: list[dict[str, Any]] = []
    for i, item in enumerate(doc):
        if not isinstance(item, dict):
            errors.append(_error("model_type", [i], item))
            continue
        record: dict[str, Any] = {}
        for feat in SCHEMA.categorical:
            value = item.get(feat.name, feat.default)
            if isinstance(value, str):
                record[feat.name] = value
            else:
                errors.append(_error("string_type", [i, feat.name], value))
        for feat in SCHEMA.numeric:
            if feat.name not in item:
                record[feat.name] = feat.default
                continue
            value = item[feat.name]
            number = _as_float(value)
            if number is not None:
                record[feat.name] = number
            elif isinstance(value, str):
                errors.append(_error("float_parsing", [i, feat.name], value))
            else:
                errors.append(_error("float_type", [i, feat.name], value))
        records.append(record)
    if errors:
        return None, errors
    return records, []


def records_to_columns(records: list[dict[str, Any]]) -> dict[str, list]:
    """Pivot validated records into columnar lists; missing keys take
    schema defaults (same rule as the JAX package's helper)."""
    columns: dict[str, list] = {name: [] for name in SCHEMA.feature_names}
    for record in records:
        for cat in SCHEMA.categorical:
            columns[cat.name].append(str(record.get(cat.name, cat.default)))
        for num in SCHEMA.numeric:
            value = record.get(num.name, num.default)
            columns[num.name].append(
                float(value) if value is not None else num.default
            )
    return columns
