"""CSV input and output in the reference's exact formats.

Two conventions coexist in the reference and both are load-bearing for the
downstream pipeline (SURVEY.md §7 'Two CSV conventions'):

* ``watcher_points.csv`` — a ``time`` *column* plus one column per watcher
  (ref run_no_diamond.py:594-600);
* ``radial_gradient[_raw].csv`` — time as the *index*, ``index.name='time'``,
  columns are z positions (ref :602-617). The fitted-curve CSVs produced by
  the split-normal analysis reuse the gradient convention.

The files are written with the ``csv`` module and numpy, byte for byte as
``pandas.DataFrame.to_csv`` writes them: floats in numpy's shortest
round-trip form for their dtype, missing values as empty fields.
"""

from __future__ import annotations

import csv
import math

import numpy as np


def _fmt(values) -> list[str]:
    """Format one column the way pandas writes it: numpy's shortest repr
    for its dtype, NaN as an empty field."""
    a = np.asarray(values)
    if a.dtype.kind == "f":
        out = a.astype(str)
        out[np.isnan(a)] = ""
        return out.tolist()
    return [_fmt_value(v) for v in a.tolist()]


def _fmt_value(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    if isinstance(v, float):
        return str(np.float64(v))
    return str(v)


def _write_rows(path: str, header: list, columns: list[list[str]]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(zip(*columns))


def write_watcher_csv(path: str, times: np.ndarray,
                      traces: dict[str, np.ndarray]) -> None:
    _write_rows(path, ["time", *traces],
                [_fmt(times)] + [_fmt(v) for v in traces.values()])


def read_watcher_csv(path: str):
    """The watcher CSV as a pandas DataFrame (analysis helper; needs the
    optional pandas dependency)."""
    import pandas as pd
    return pd.read_csv(path)


def write_gradient_csv(path: str, times: np.ndarray, columns: np.ndarray,
                       rows: np.ndarray) -> None:
    """rows: (n_times, n_columns); columns are z positions (floats)."""
    rows = np.asarray(rows)
    header = ["time", *_fmt(np.asarray(columns))]
    _write_rows(path, header,
                [_fmt(times)] + [_fmt(rows[:, j])
                                 for j in range(rows.shape[1])])


def read_gradient_csv(path: str):
    """Return (times (T,), z_positions (Z,), values (T, Z)) — the parsing the
    1D driver and the plotting layer rely on (ref run_no_diamond_1d.py:348-351,
    plot_radial_gradient.py:43-63)."""
    header, rows = read_csv_rows(path)
    z = np.asarray([float(c) for c in header[1:]])
    data = np.asarray([[_to_float(x) for x in r] for r in rows], float)
    data = data.reshape(len(rows), len(header))
    return data[:, 0], z, data[:, 1:]


def _to_float(text: str) -> float:
    """A field as a number, NaN when it is not one (pandas'
    ``to_numeric(errors='coerce')``)."""
    text = text.strip()
    if not text or "_" in text:
        return math.nan
    try:
        return float(text)
    except ValueError:
        return math.nan


def read_csv_rows(path: str) -> tuple[list[str], list[list[str]]]:
    """(header, rows) of a CSV file, blank lines skipped and short rows
    padded with empty fields."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r and any(x.strip() for x in r)]
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    header, body = rows[0], rows[1:]
    n = len(header)
    return header, [(r + [""] * (n - len(r)))[:n] for r in body]


def read_numeric_columns(path: str) -> dict[str, np.ndarray]:
    """Every column of a headed CSV as a float array (non-numbers → NaN)."""
    header, rows = read_csv_rows(path)
    return {name: np.asarray([_to_float(r[j]) for r in rows], float)
            for j, name in enumerate(header)}


def write_records_csv(path: str, records: list[dict]) -> None:
    """A list of flat dicts as a CSV table (columns in order of first
    appearance, None/NaN as empty fields) — the sweep's run tables."""
    cols: list = []
    for rec in records:
        cols.extend(k for k in rec if k not in cols)
    _write_rows(path, cols, [[_fmt_value(rec.get(c)) for rec in records]
                             for c in cols])


def read_records_csv(path: str) -> list[dict]:
    """Rows of a table written by :func:`write_records_csv`; integer and
    float fields come back as numbers, empty fields as None."""
    header, rows = read_csv_rows(path)

    def value(text):
        if text == "":
            return None
        for cast in (int, float):
            try:
                return cast(text)
            except ValueError:
                pass
        return text

    return [{k: value(v) for k, v in zip(header, r)} for r in rows]
