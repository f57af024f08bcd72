"""
What the scenario initializers and the INTERACTION loaders share: their
error, and a CSV reader with the standard library (no dataframe library
is needed).
"""
import csv
from typing import Dict, List

import numpy as np


class InitializationFailedError(RuntimeError):
    """A scenario could not be initialized: agents could not be placed
    without overlaps, or a recording lacks the frames asked for."""


def read_csv_columns(path: str) -> Dict[str, List[str]]:
    """The CSV file's columns by header name, each a list of its fields
    as text, in row order."""
    with open(path, newline='') as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return {name: [row[i] for row in rows] for i, name in enumerate(header)}


def numeric_column(values: List[str]) -> np.ndarray:
    """A column of numbers: int64 when every field is an integer, else
    float64 with an empty field read as NaN."""
    try:
        return np.asarray([int(v) for v in values], dtype=np.int64)
    except ValueError:
        return np.asarray([float(v) if v != '' else np.nan for v in values],
                          dtype=np.float64)
