"""A CSV reader for ``POST /files/`` on the stdlib ``csv`` module.

The JAX app reads uploads with ``pandas.read_csv`` and echoes
``df.head(1000).to_dict(orient="records")``; pandas is not installed
where the port serves, so this module reproduces what that call gives
for ordinary files:

- the first row is the header; an empty name becomes ``Unnamed: i``
  and a repeated one ``name.1``, ``name.2`` …; blank lines are skipped;
  a short row is padded with missing values; when the first data row
  has one field more than the header, the first field of every row is
  the index (not echoed), as pandas infers it, and a row longer than
  that is an error;
- a cell in pandas' default NA set (``""``, ``NA``, ``null``, ``nan`` …)
  is missing;
- a column whose present cells are all integers (surrounding spaces
  allowed) and that has no missing cell is an int column; one whose
  present cells are all numbers is a float column, missing cells NaN;
  one whose present cells are all ``True``/``False`` (any of pandas'
  three spellings) is a bool column, missing cells NaN; every other column
  keeps its cells' text, missing cells NaN; an all-missing column is
  NaN.

:func:`read_csv` returns the column names, the row count and the
records as Python values, so ``json.dumps`` writes what the JAX app
writes (``NaN`` and ``Infinity`` included).
"""

from __future__ import annotations

import csv
import io
import math

NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})


class CSVError(ValueError):
    """Input ``read_csv`` cannot parse (the app answers 400)."""


def _as_int(cell: str):
    s = cell.strip()
    if not s or "_" in s:
        return None
    try:
        return int(s)
    except ValueError:
        return None


def _as_float(cell: str):
    s = cell.strip()
    if not s or "_" in s:
        return None
    try:
        return float(s)
    except ValueError:
        return None


def _column(cells: list) -> list:
    """One column's cells (``None`` = missing) → its Python values."""
    present = [c for c in cells if c is not None]
    missing = len(present) < len(cells)
    if not present:
        return [math.nan] * len(cells)
    ints = [_as_int(c) for c in present]
    if not missing and all(v is not None for v in ints):
        return ints
    floats = [_as_float(c) for c in present]
    if all(v is not None for v in floats):
        it = iter(floats)
        return [math.nan if c is None else next(it) for c in cells]
    if all(c in _TRUE or c in _FALSE for c in present):
        return [math.nan if c is None else c in _TRUE for c in cells]
    return [math.nan if c is None else c for c in cells]


def _names(header: list) -> list[str]:
    out: list[str] = []
    seen: dict[str, int] = {}
    for i, name in enumerate(header):
        name = name or f"Unnamed: {i}"
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        else:
            seen[name] = 0
        out.append(name)
    return out


def read_csv(text: str, max_records: int | None = None):
    """``(columns, n_rows, records)`` of a CSV document; ``records``
    holds the first ``max_records`` rows (all when ``None``) as
    ``{column: value}`` dicts. Raises :class:`CSVError` on an empty
    document or a row longer than the header."""
    try:
        rows = [r for r in csv.reader(io.StringIO(text, newline=""))
                if r != []]
    except csv.Error as e:
        raise CSVError(str(e)) from None
    if not rows:
        raise CSVError("No columns to parse from file")
    names = _names(rows[0])
    width = len(names)
    body = rows[1:]
    if body and len(body[0]) == width + 1:
        body = [row[1:] for row in body]   # an implicit index column
    for i, row in enumerate(body):
        if len(row) > width:
            raise CSVError(f"Error tokenizing data. Expected {width} fields "
                           f"in line {i + 2}, saw {len(row)}")
    columns = [
        _column([
            (row[j] if j < len(row) and row[j] not in NA_VALUES else None)
            for row in body
        ])
        for j in range(width)
    ]
    n = len(body) if max_records is None else min(len(body), max_records)
    records = [{names[j]: columns[j][i] for j in range(width)}
               for i in range(n)]
    return names, len(body), records
