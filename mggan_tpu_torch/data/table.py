"""A reader for delimited rows, for what the JAX parser takes from
``pandas.read_csv`` (``mggan_tpu/data/parsing.py:61-76``,
``mggan_tpu/data/registry.py:155-158``), so the port's data path does not
need pandas.

It keeps the part of ``read_csv``'s defaults those calls rely on:
  * pandas' default quoting: a field may be quoted with ``"``, a doubled
    ``""`` inside it is one quote, and a quoted field may hold the
    delimiter;
  * blank lines are skipped; the first row fixes the column count, a
    shorter row is filled with missing values and a longer one raises;
  * a column is numeric when every field in it parses as a number or is
    one of pandas' missing-value markers: int64 when every field is an
    integer and none is missing, else float64 with NaN for the missing
    ones; any other column holds strings (object), NaN where missing.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path

import numpy as np

# pandas' default missing-value markers (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)",
                    re.IGNORECASE)


def _column(fields: list):
    """One column's fields (None for a missing field of a short row) as
    pandas would type them."""
    present = [f for f in fields if f is not None and f not in NA_VALUES]
    missing = len(present) < len(fields)
    if all(_INT.fullmatch(f) for f in present) and not missing:
        return np.array([int(f) for f in fields], np.int64)
    if all(_FLOAT.fullmatch(f) for f in present):
        return np.array([float(f) if f is not None and f not in NA_VALUES else np.nan
                         for f in fields], np.float64)
    return np.array([f if f is not None and f not in NA_VALUES else np.nan for f in fields],
                    dtype=object)


def read_table(path, delimiter: str, names=None, header: bool = False) -> dict:
    """The columns of a delimited text file, ``{name: array}`` in file order.

    ``header``: the first row names the columns. Otherwise they are named
    ``names[:ncols]``, as the JAX parser names ``read_csv``'s columns
    ``data_columns[:len(df.columns)]`` (or 0, 1, ... without ``names``).
    """
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh, delimiter=delimiter, quotechar='"',
                                      doublequote=True) if r]
    if header:
        if not rows:
            raise ValueError(f"{path}: no header row")
        names, rows = rows[0], rows[1:]
    ncols = len(rows[0]) if rows else len(names or ())
    for i, r in enumerate(rows):
        if len(r) > ncols:
            raise ValueError(f"{Path(path).name}: expected {ncols} fields in row {i + 1}, "
                             f"saw {len(r)}")
    if names is None:
        names = list(range(ncols))
    elif len(names) < ncols:
        raise ValueError(f"{Path(path).name}: {ncols} columns, {len(names)} names")
    return {names[c]: _column([r[c] if c < len(r) else None for r in rows])
            for c in range(ncols)}


def equals(column: np.ndarray, value) -> np.ndarray:
    """``column == value`` as pandas compares a Series with a scalar: a
    string never equals a number, and NaN equals nothing."""
    if column.dtype == object:
        return np.array([isinstance(v, str) and isinstance(value, str) and v == value
                         for v in column], bool)
    if isinstance(value, str):
        return np.zeros(len(column), bool)
    return column == value
