"""One renderer for every human-facing report line.

A copy of `repro.obs.render` (numpy + stdlib).

`WindowReport.line()`, `IngestWindowReport.line()`, `StreamReport.summary()`,
`IngestReport.summary()` and the launchers' dashboard all used to hand-roll
their own f-strings; they now build `(key, value)` pairs and let
`render_line` format them uniformly: floats to 3 decimals, bools as
`ok`/`FAIL`, `None` values skipped, sequences compact.
"""
from __future__ import annotations


def fmt_value(value) -> str:
    if isinstance(value, bool):
        return "ok" if value else "FAIL"
    if isinstance(value, float):
        return f"{value:.3f}"
    if isinstance(value, (list, tuple)):
        return "[" + ",".join(fmt_value(v) for v in value) + "]"
    return str(value)


def render_line(tag: str, fields, *, sep: str = "  ") -> str:
    """`tag  k1=v1  k2=v2 ...`; fields is a dict or (key, value) pairs.

    A `None` value drops the pair; a key starting with `@` renders the
    value bare (no `key=` prefix) — for pre-formatted fragments like
    `window  12` or `+3docs`.
    """
    pairs = fields.items() if hasattr(fields, "items") else fields
    parts = [tag] if tag else []
    for k, v in pairs:
        if v is None:
            continue
        parts.append(fmt_value(v) if k.startswith("@") else
                     f"{k}={fmt_value(v)}")
    return sep.join(parts)
